"""Operation and byte count of a step (port of ``repro/launch/hlo_cost.py``).

The reference walks post-SPMD HLO text.  The port has no HLO: this module
counts the ATen operations that torch dispatches while a function runs,
under a ``TorchDispatchMode``.  The file keeps its name so that its
counterpart is easy to find.  Per executed operation:

  * dot FLOPs    2 · |result| · contraction over matmul, ``bmm``,
                 ``addmm``, ``baddbmm`` and SDPA, as
                 ``torch.utils.flop_counter.FlopCounterMode`` reckons them
  * elementwise  |result| per other compute operation (views, copies,
                 casts, indexing, concatenation and factories count 0)
  * bytes        operands + result per operation, views excluded.  Eager
                 torch does not fuse, so this is an upper bound on HBM
                 traffic, not the reference's fusion-level count
  * collectives  operand bytes by kind, from the tally of
                 ``core.distributed.record_collectives``

Count on the plain versions: run ``fn`` on ``meta`` tensors (shapes
only; ``launch.input_specs``), where every kernel wrapper takes its
plain PyTorch version.  A hand-written kernel is called through
``ctypes`` and is opaque to the dispatcher, so a count taken on the card
would leave out exactly the kernels' work.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch.core.distributed import COLLECTIVES, record_collectives

aten = torch.ops.aten

# operations that move, cast, index or make data without arithmetic (the
# reference's zero-FLOP HLO ops: copy, convert, gather, scatter, concat,
# pad, iota, broadcast, rng, …); views count nothing at all
_ZERO_FLOP = {
    aten._to_copy, aten.copy_, aten.clone, aten.cat, aten.stack,
    aten.constant_pad_nd, aten.empty, aten.empty_like, aten.empty_strided,
    aten.zeros, aten.zeros_like, aten.ones, aten.ones_like, aten.full,
    aten.full_like, aten.fill_, aten.zero_, aten.arange, aten.new_empty,
    aten.new_empty_strided, aten.new_zeros, aten.new_ones, aten.new_full,
    aten.scalar_tensor, aten.index, aten.index_put_, aten.index_put,
    aten._index_put_impl_, aten.index_select, aten.gather, aten.scatter,
    aten.embedding, aten.repeat, aten.roll, aten.flip, aten.select_scatter,
    aten.slice_scatter, aten.lift_fresh, aten.lift_fresh_copy,
    aten.randn, aten.normal_, aten.uniform_, aten.multinomial,
    aten.tril_indices, aten.triu_indices, aten._local_scalar_dense,
}
_FACTORIES = {aten.empty, aten.empty_like, aten.empty_strided, aten.zeros,
              aten.zeros_like, aten.ones, aten.ones_like, aten.full,
              aten.full_like, aten.arange, aten.new_empty,
              aten.new_empty_strided, aten.new_zeros, aten.new_ones,
              aten.new_full, aten.scalar_tensor, aten.randn}


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


def _numel(tree) -> int:
    return sum(t.numel() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


@dataclasses.dataclass
class Cost:
    dot_flops: float = 0.0
    elem_flops: float = 0.0
    bytes: float = 0.0
    coll: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVES})

    @property
    def flops(self) -> float:
        return self.dot_flops + self.elem_flops

    @property
    def coll_bytes(self) -> float:
        return sum(self.coll.values())


class _Ops(TorchDispatchMode):
    """Elementwise operations and bytes of every dispatched operation."""

    def __init__(self):
        super().__init__()
        self.elem = 0.0
        self.bytes = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if func.is_view:
            return out
        if packet not in flop_registry and packet not in _ZERO_FLOP:
            self.elem += _numel(out)
        read = 0 if packet in _FACTORIES else _nbytes((args, kwargs))
        self.bytes += read + _nbytes(out)
        return out


class OpTrace(TorchDispatchMode):
    """The sequence of dispatched operations, each with its outputs'
    shapes and dtypes (``analysis.compile`` compares two runs)."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        shapes = [(tuple(t.shape), str(t.dtype)) for t in tree_flatten(out)[0]
                  if isinstance(t, torch.Tensor)]
        self.ops.append(f"{func} -> {shapes}")
        return out


def count(fn: Callable, *args: Any, **kwargs: Any) -> Cost:
    """The :class:`Cost` of one call ``fn(*args, **kwargs)``."""
    with record_collectives() as tally:
        with FlopCounterMode(display=False) as flops, _Ops() as ops:
            fn(*args, **kwargs)
    return Cost(dot_flops=float(flops.get_total_flops()),
                elem_flops=ops.elem, bytes=ops.bytes,
                coll={k: float(tally[k]) for k in COLLECTIVES})
