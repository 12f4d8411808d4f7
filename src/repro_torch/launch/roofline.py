"""Roofline terms of a counted step on the H100 (port of
``repro/launch/roofline.py``).

    compute term    = FLOPs / (chips × peak bf16 FLOP/s)
    memory term     = bytes / (chips × HBM bandwidth)
    collective term = collective bytes / (chips × NVLink bandwidth)

FLOPs, bytes and collective bytes come from ``launch.hlo_cost.count``
(:func:`from_count`, in place of the reference's ``from_compiled``); the
peaks are ``launch.mesh``'s H100 SXM data-sheet rates.  The eager byte
count is an upper bound (no fusion), so the memory term is too.
"""
from __future__ import annotations

import dataclasses
import functools
import re
from typing import Dict, Optional

from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16


@dataclasses.dataclass
class Roofline:
    """Per-chip quantities: a count of one rank's program over one card's
    rates."""
    flops: float                 # per-chip FLOPs
    hbm_bytes: float             # per-chip bytes accessed
    coll_bytes: float            # per-chip collective operand bytes
    coll_by_kind: Dict[str, int]
    n_chips: int
    model_flops: float = 0.0     # 6·N·D analytic useful FLOPs (GLOBAL)

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flop_ratio(self) -> Optional[float]:
        if self.model_flops and self.flops:
            return (self.model_flops / self.n_chips) / self.flops
        return None

    def row(self) -> Dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_flop_ratio,
            "coll_by_kind": self.coll_by_kind,
        }


def from_count(cost, n_chips: int = 1, model_flops: float = 0.0
               ) -> Roofline:
    """Roofline terms of a ``hlo_cost.Cost`` (one rank's count)."""
    return Roofline(flops=cost.flops, hbm_bytes=cost.bytes,
                    coll_bytes=cost.coll_bytes,
                    coll_by_kind={k: int(v) for k, v in cost.coll.items()},
                    n_chips=n_chips, model_flops=model_flops)


# ---------------------------------------------------------------------------
# analytic MODEL_FLOPS (6·N·D for train, 2·N·D for single forward)
# ---------------------------------------------------------------------------


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, path)
        else:
            yield path, v


@functools.lru_cache(maxsize=None)
def active_params(cfg) -> float:
    """Parameter count with only top_k of n_experts counted (MoE); one
    ``meta`` build of the parameters per config."""
    from repro_torch.launch.input_specs import params_shapes

    total = 0.0
    for name, leaf in _leaves(params_shapes(cfg)):
        n = 1
        for s in leaf.shape:
            n *= s
        if cfg.n_experts and re.search(r"we_(in|out|gate)", name):
            n = n * cfg.top_k / cfg.n_experts
        total += n
    return total


def model_flops_for(cfg, shape, mode: str) -> float:
    """6·N_active·D train; 2·N·D forward; decode processes B·1 tokens."""
    n = active_params(cfg)
    if mode == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    tokens = shape.global_batch * 1
    return 2.0 * n * tokens
