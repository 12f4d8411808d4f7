"""Kernel entry points (port of ``repro/kernels/ops.py``).

The tensor's device picks the path: a CUDA tensor launches the hand-written
kernel (or the wrapper raises), a CPU tensor takes the plain version in
``ref``.  There is no fallback from a failed kernel to the plain version.

Gradients: on the CPU autograd differentiates the plain versions.  On the
card, when grad is on and an input requires it, ``attention`` takes
``FlashAttention``, ``wkv6`` takes ``WKV6`` and ``ssd`` takes ``SSD``: each
the forward kernel, then its hand-written backward kernel, at every shape
of the forward.

``record_calls`` lists the wrappers' calls on any device: their shapes,
layouts and keywords (the dry run reads the attention masks from it, and
``chip_smoke.py`` replays each call against its plain version).
``OUTPUT_CHECKS`` receives each wrapper's name and outputs on any device:
a kernel writes through ``ctypes``, where no dispatch mode sees it, so
``analysis.sanitize`` checks the outputs for NaN / Inf here.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch

from repro_torch.kernels import attention_cached as _ac
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_attention_bwd as _fab
from repro_torch.kernels import gmm_estep as _ge
from repro_torch.kernels import ref
from repro_torch.kernels import rms_norm as _rms
from repro_torch.kernels import ssd as _ssd
from repro_torch.kernels import ssd_bwd as _ssdb
from repro_torch.kernels import wkv6 as _wkv6
from repro_torch.kernels import wkv6_bwd as _wkv6b

__all__ = ["gmm_estep", "gmm_estep_fused", "attention", "attention_cached",
           "wkv6", "ssd", "rms_norm", "launch_counts", "reset_launch_counts",
           "record_calls", "Call", "TensorSpec", "OUTPUT_CHECKS"]

_KERNEL_COUNTS = (_ge.LAUNCHES, _fa.LAUNCHES, _fab.LAUNCHES, _ac.LAUNCHES,
                  _wkv6.LAUNCHES, _wkv6b.LAUNCHES, _ssd.LAUNCHES,
                  _ssdb.LAUNCHES, _rms.LAUNCHES)


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """A tensor argument's shape, strides, dtype and storage offset modulo
    16 bytes (a view's alignment picks a kernel's route)."""
    shape: Tuple[int, ...]
    stride: Tuple[int, ...]
    dtype: torch.dtype
    offset: int

    @classmethod
    def of(cls, t: torch.Tensor) -> "TensorSpec":
        off = 0 if t.is_meta else (t.data_ptr() % 16) // t.element_size()
        return cls(tuple(t.shape), tuple(t.stride()), t.dtype, off)


@dataclasses.dataclass(frozen=True)
class Call:
    """One wrapper call: the kernel's name, its tensor arguments in order,
    its keywords, whether autograd takes the backward kernel too, and the
    integer position tensors' values (CPU copies; None on ``meta``)."""
    name: str
    tensors: Tuple[TensorSpec, ...]
    kw: Tuple[Tuple[str, object], ...]
    grad: bool
    positions: Optional[Tuple[torch.Tensor, ...]] = None

    @property
    def key(self):
        """What makes two calls the same work (positions aside)."""
        return self.name, self.tensors, self.kw, self.grad


_RECORDING: List[List[Call]] = []
# (wrapper name, outputs) → None or raise; armed by analysis.sanitize
OUTPUT_CHECKS: List[Callable[[str, object], None]] = []


def _checked(name: str, out):
    """``out`` after every armed output check has read it."""
    for check in OUTPUT_CHECKS:
        check(name, out)
    return out


@contextlib.contextmanager
def record_calls() -> Iterator[List[Call]]:
    """Every kernel wrapper call inside the block, as a :class:`Call`."""
    calls: List[Call] = []
    _RECORDING.append(calls)
    try:
        yield calls
    finally:
        _RECORDING.remove(calls)


def _record(name, tensors, grad, positions=(), **kw) -> Optional[Call]:
    if not _RECORDING:
        return None
    pos = None if any(p.is_meta for p in positions) else tuple(
        p.detach().to("cpu", copy=True) for p in positions)
    call = Call(name, tuple(TensorSpec.of(t) for t in tensors),
                tuple(sorted(kw.items())), grad, pos)
    for calls in _RECORDING:
        calls.append(call)
    return call


def _record_backward(call: Optional[Call], out: torch.Tensor) -> None:
    """Record ``call`` again, named ``<name>_bwd``, each time a gradient
    reaches ``out`` (once a backward: under activation checkpointing the
    recomputed forward is recorded, its output gets no gradient)."""
    if call is None or not call.grad:
        return
    bwd = dataclasses.replace(call, name=f"{call.name}_bwd")

    def hook(grad):
        for calls in _RECORDING:
            calls.append(bwd)
    out.register_hook(hook)


def gmm_estep(x, mu, var, pi):
    """(N, d) × (K, d) diag/spher E-step numerators → (N, K)."""
    if x.is_cuda:
        return _checked("gmm_estep", _ge.estep(x, mu, var, pi))
    return _checked("gmm_estep", ref.estep_ref(x, mu, var, pi))


def gmm_estep_fused(x, mu, var, pi):
    """Fused batched E-step → (log-numerators (…, N, K), row lse (…, N)).

    One call covers a whole (B = clients × classes) stack of fits; x may
    be (Bx, N, d) shared by B // Bx consecutive fits.
    """
    if x.is_cuda:
        return _checked("gmm_estep_fused", _ge.estep_fused(x, mu, var, pi))
    return _checked("gmm_estep_fused", ref.estep_fused_ref(x, mu, var, pi))


def attention(q, k, v, *, causal=True, window=0, prefix=0):
    """(B, H, Sq, D) × (B, Hkv, Sk, D) attention → (B, H, Sq, D)."""
    call = _record("attention", (q, k, v), _wants_grad(q, k, v),
                   causal=causal, window=window, prefix=prefix)
    if q.is_cuda:
        if _wants_grad(q, k, v):
            o = _fab.FlashAttention.apply(q, k, v, causal, window, prefix)
        else:
            o = _fa.flash_attention(q, k, v, causal=causal, window=window,
                                    prefix=prefix)
    else:
        o = ref.attention_ref(q, k, v, causal=causal, window=window,
                              prefix=prefix)
    _record_backward(call, o)
    return _checked("attention", o)


def attention_cached(q, k, v, q_pos, kv_pos, *, causal=True, window=0):
    """(B, H, Sq, D) queries at positions q_pos (B, Sq) over a KV cache
    (B, Hkv, Sk, D) whose slots hold positions kv_pos (B, Sk), < 0 empty
    → (B, H, Sq, D)."""
    _record("attention_cached", (q, k, v, q_pos, kv_pos), False,
            (q_pos, kv_pos), causal=causal, window=window)
    if q.is_cuda:
        o = _ac.attention_cached(q, k, v, q_pos, kv_pos, causal=causal,
                                 window=window)
    else:
        o = ref.attention_positions_ref(q, k, v, q_pos, kv_pos,
                                        causal=causal, window=window)
    return _checked("attention_cached", o)


def wkv6(r, k, v, lw, u, s0, chunk: int = 16):
    """(B, H, T, Dh) WKV6 recurrence → (out, final state)."""
    _record("wkv6", (r, k, v, lw, u, s0), _wants_grad(r, k, v, lw, u, s0),
            chunk=chunk)
    if r.is_cuda:
        if _wants_grad(r, k, v, lw, u, s0):
            out = _wkv6b.WKV6.apply(r, k, v, lw, u, s0, chunk)
        else:
            out = _wkv6.wkv6(r, k, v, lw, u, s0, chunk=chunk)
    else:
        out = ref.wkv6_ref(r, k, v, lw, u, s0, chunk=chunk)
    return _checked("wkv6", out)


def ssd(x, a_log, B, C, s0, chunk: int = 64):
    """(Bt, H, T, P) Mamba2 SSD recurrence → (y, final state)."""
    _record("ssd", (x, a_log, B, C, s0), _wants_grad(x, a_log, B, C, s0),
            chunk=chunk)
    if x.is_cuda:
        if _wants_grad(x, a_log, B, C, s0):
            out = _ssdb.SSD.apply(x, a_log, B, C, s0, chunk)
        else:
            out = _ssd.ssd(x, a_log, B, C, s0, chunk=chunk)
    else:
        out = ref.ssd_ref(x, a_log, B, C, s0, chunk=chunk)
    return _checked("ssd", out)


def rms_norm(x, gamma, z=None, eps: float = 1e-6):
    """(…, d) RMS norm over the last dim → (…, d) in x's dtype; with the
    gate ``z`` (x's shape) times silu(z).  On the card the one-pass kernel,
    which has no backward: a call that wants a gradient raises (the model
    keeps the plain expression for training, ``models.layers.rms_norm``)."""
    if x.is_cuda:
        if _wants_grad(x, gamma, z):
            raise ValueError("rms_norm: the kernel has no backward; take "
                             "ref.rms_norm_ref where a gradient is wanted")
        out = _rms.rms_norm(x, gamma, z, eps=eps)
    else:
        out = ref.rms_norm_ref(x, gamma, z, eps=eps)
    return _checked("rms_norm", out)


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far, and plain versions run on CUDA tensors."""
    counts = {k: v for table in _KERNEL_COUNTS for k, v in table.items()}
    counts.update({f"plain_on_cuda.{k}": v
                   for k, v in ref.CUDA_CALLS.items()})
    return counts


def reset_launch_counts() -> None:
    for table in (*_KERNEL_COUNTS, ref.CUDA_CALLS):
        for name in table:
            table[name] = 0
