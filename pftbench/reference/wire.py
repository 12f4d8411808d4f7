"""The FedPFT wire of a diagonal mixture message, read from its bytes.

A message ships the mixtures of the classes its client holds (count > 0), in
class order: all pi (Cp, K), then all mu (Cp, K, d), then all cov (Cp, K, d),
each scalar as the two bytes of its bfloat16, little-endian (paper Eqs.
9-11).  The counts travel beside the payload and are not counted in it.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def payload_bytes(counts: Sequence[int], K: int, d: int) -> int:
    """Eqs. 9-11 for a diagonal mixture: (K + 2 K d) bf16 scalars per
    present class."""
    present = sum(1 for c in counts if c > 0)
    return present * (K + 2 * K * d) * 2


def bf16_to_f32(raw: np.ndarray) -> np.ndarray:
    """bfloat16 bit patterns (uint16) as float32 values, exactly."""
    return (raw.astype(np.uint32) << np.uint32(16)).view(np.float32)


def decode(payload: bytes, counts: Sequence[int], K: int, d: int
           ) -> Dict[str, np.ndarray]:
    """{pi (C, K), mu (C, K, d), cov (C, K, d)} float32 of a payload; the
    rows of absent classes are NaN."""
    present = [c for c, n in enumerate(counts) if n > 0]
    Cp, C = len(present), len(counts)
    raw = np.frombuffer(payload, dtype="<u2")
    sizes = {"pi": Cp * K, "mu": Cp * K * d, "cov": Cp * K * d}
    if raw.size != sum(sizes.values()):
        raise ValueError(f"payload holds {raw.size} scalars, the schema "
                         f"{sum(sizes.values())}")
    out, off = {}, 0
    for name, shape in (("pi", (K,)), ("mu", (K, d)), ("cov", (K, d))):
        vals = bf16_to_f32(raw[off:off + sizes[name]]).reshape((Cp,) + shape)
        full = np.full((C,) + shape, np.nan, np.float32)
        full[present] = vals
        out[name] = full
        off += sizes[name]
    return out
