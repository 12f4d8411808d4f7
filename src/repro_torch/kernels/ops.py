"""Kernel entry points (port of ``repro/kernels/ops.py``).

The tensor's device picks the path: a CUDA tensor launches the hand-written
kernel (or the wrapper raises), a CPU tensor takes the plain version in
``ref``.  There is no fallback from a failed kernel to the plain version.

Gradients: on the CPU autograd differentiates the plain versions.  On the
card, when grad is on and an input requires it, ``attention`` takes
``FlashAttention``, ``wkv6`` takes ``WKV6`` and ``ssd`` takes ``SSD``: each
the forward kernel, then its hand-written backward kernel, at every shape
of the forward.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import attention_cached as _ac
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_attention_bwd as _fab
from repro_torch.kernels import gmm_estep as _ge
from repro_torch.kernels import ref
from repro_torch.kernels import ssd as _ssd
from repro_torch.kernels import ssd_bwd as _ssdb
from repro_torch.kernels import wkv6 as _wkv6
from repro_torch.kernels import wkv6_bwd as _wkv6b

__all__ = ["gmm_estep", "gmm_estep_fused", "attention", "attention_cached",
           "wkv6", "ssd", "launch_counts", "reset_launch_counts"]

_KERNEL_COUNTS = (_ge.LAUNCHES, _fa.LAUNCHES, _fab.LAUNCHES, _ac.LAUNCHES,
                  _wkv6.LAUNCHES, _wkv6b.LAUNCHES, _ssd.LAUNCHES,
                  _ssdb.LAUNCHES)


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def gmm_estep(x, mu, var, pi):
    """(N, d) × (K, d) diag/spher E-step numerators → (N, K)."""
    if x.is_cuda:
        return _ge.estep(x, mu, var, pi)
    return ref.estep_ref(x, mu, var, pi)


def gmm_estep_fused(x, mu, var, pi):
    """Fused batched E-step → (log-numerators (…, N, K), row lse (…, N)).

    One call covers a whole (B = clients × classes) stack of fits; x may
    be (Bx, N, d) shared by B // Bx consecutive fits.
    """
    if x.is_cuda:
        return _ge.estep_fused(x, mu, var, pi)
    return ref.estep_fused_ref(x, mu, var, pi)


def attention(q, k, v, *, causal=True, window=0, prefix=0):
    """(B, H, Sq, D) × (B, Hkv, Sk, D) attention → (B, H, Sq, D)."""
    if q.is_cuda:
        if _wants_grad(q, k, v):
            return _fab.FlashAttention.apply(q, k, v, causal, window, prefix)
        return _fa.flash_attention(q, k, v, causal=causal, window=window,
                                   prefix=prefix)
    return ref.attention_ref(q, k, v, causal=causal, window=window,
                             prefix=prefix)


def attention_cached(q, k, v, q_pos, kv_pos, *, causal=True, window=0):
    """(B, H, Sq, D) queries at positions q_pos (B, Sq) over a KV cache
    (B, Hkv, Sk, D) whose slots hold positions kv_pos (B, Sk), < 0 empty
    → (B, H, Sq, D)."""
    if q.is_cuda:
        return _ac.attention_cached(q, k, v, q_pos, kv_pos, causal=causal,
                                    window=window)
    return ref.attention_positions_ref(q, k, v, q_pos, kv_pos,
                                       causal=causal, window=window)


def wkv6(r, k, v, lw, u, s0, chunk: int = 16):
    """(B, H, T, Dh) WKV6 recurrence → (out, final state)."""
    if r.is_cuda:
        if _wants_grad(r, k, v, lw, u, s0):
            return _wkv6b.WKV6.apply(r, k, v, lw, u, s0, chunk)
        return _wkv6.wkv6(r, k, v, lw, u, s0, chunk=chunk)
    return ref.wkv6_ref(r, k, v, lw, u, s0, chunk=chunk)


def ssd(x, a_log, B, C, s0, chunk: int = 64):
    """(Bt, H, T, P) Mamba2 SSD recurrence → (y, final state)."""
    if x.is_cuda:
        if _wants_grad(x, a_log, B, C, s0):
            return _ssdb.SSD.apply(x, a_log, B, C, s0, chunk)
        return _ssd.ssd(x, a_log, B, C, s0, chunk=chunk)
    return ref.ssd_ref(x, a_log, B, C, s0, chunk=chunk)


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
