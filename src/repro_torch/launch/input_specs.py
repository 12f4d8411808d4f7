"""Static input specs of the round program (port of
``repro/launch/input_specs.py::round_specs_for``).

The reference hands these to ``round_program.lower(...)`` as
``ShapeDtypeStruct``\\ s; the port allocates from them the static input
buffers a captured CUDA graph reads on every replay.  The model dry-run
specs wait for ROADMAP item 9.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

Spec = Tuple[Tuple[int, ...], torch.dtype]


def round_specs_for(sig) -> Tuple[Optional[Spec], ...]:
    """``(shape, dtype)`` of each positional input of
    ``fl.round.round_program`` — ``(pi, mu, cov, counts, slot_labels)`` —
    by the signature's layout; ``slot_labels`` is None in the wire layout
    (the program derives the labels)."""
    from repro_torch.fl.round import WIRE_DTYPES
    if sig.layout == "wire":
        wd = WIRE_DTYPES[sig.dtype]
        lead = (sig.M, sig.C)
        return ((lead + (sig.K,), wd),
                (lead + (sig.K, sig.d), wd),
                (lead + sig.cov_shape(packed=True), wd),
                (lead, torch.int32),
                None)
    return (((sig.M, sig.K), torch.float32),
            ((sig.M, sig.K, sig.d), torch.float32),
            ((sig.M,) + sig.cov_shape(packed=False), torch.float32),
            ((sig.M,), torch.int32),
            ((sig.M,), torch.int32))
