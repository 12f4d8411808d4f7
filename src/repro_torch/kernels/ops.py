"""Kernel entry points (port of ``repro/kernels/ops.py``).

The tensor's device picks the path: a CUDA tensor launches the hand-written
kernel (or the wrapper raises), a CPU tensor takes the plain version in
``ref``.  There is no fallback from a failed kernel to the plain version.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import gmm_estep as _ge
from repro_torch.kernels import ref

__all__ = ["gmm_estep", "gmm_estep_fused", "attention", "launch_counts",
           "reset_launch_counts"]


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
        return _fa.flash_attention(q, k, v, causal=causal, window=window,
                                   prefix=prefix)
    return ref.attention_ref(q, k, v, causal=causal, window=window,
                             prefix=prefix)


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far, and plain versions run on CUDA tensors."""
    counts = {**_ge.LAUNCHES, **_fa.LAUNCHES}
    counts.update({f"plain_on_cuda.{k}": v
                   for k, v in ref.CUDA_CALLS.items()})
    return counts


def reset_launch_counts() -> None:
    for table in (_ge.LAUNCHES, _fa.LAUNCHES, ref.CUDA_CALLS):
        for name in table:
            table[name] = 0
