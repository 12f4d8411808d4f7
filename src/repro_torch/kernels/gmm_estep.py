"""GMM E-step on the card: wrapper of ``csrc/gmm_estep.cu``.

Port of ``repro/kernels/gmm_estep.py`` (Pallas ``estep_fused`` / ``estep``).
One CUDA source serves both entry points: ``estep_fused`` returns the
(B, N, K) log-numerators and their (B, N) row logsumexp, ``estep`` the
numerators of one fit.  The per-component terms ``inv = 1/var``,
``μ·inv`` and ``c_k = log π_k − ½(d·log2π + Σlog σ² + Σμ²/σ²)`` are small
elementwise torch ops here, as in the reference's ``_estep_call``; the
kernel does the two products over d and the logsumexp (see the note at
the top of the ``.cu`` file for its design and bound).

These wrappers take CUDA tensors only; ``ops`` sends CPU tensors to the
plain versions in ``ref``.  ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build

_SOURCE = "gmm_estep.cu"
_LOG2PI = math.log(2.0 * math.pi)
_MAX_GRID_Y = 65535

LAUNCHES: Dict[str, int] = {"estep_fused": 0, "estep": 0}


def _lib() -> ctypes.CDLL:
    lib = _build.load(_SOURCE)
    fn = lib.estep_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _prep(x, mu, var, pi):
    """Batched f32: x (Bx, N, d); mu, var (B, K, d); pi (B, K)."""
    batched = mu.dim() == 3
    if not batched:
        mu, var, pi = mu[None], var[None], pi[None]
    if x.dim() == 2:
        x = x[None]
    mu = mu.float()
    var = var.float()
    if var.dim() == mu.dim() - 1:                 # spher (B, K) → (B, K, d)
        var = var[..., None]
    return batched, x.float().contiguous(), mu, var.expand(mu.shape), \
        pi.float()


def _launch(x, mu, var, pi, *, fused: bool
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    for name, t in (("x", x), ("mu", mu), ("var", var), ("pi", pi)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"gmm_estep: {name} must be a CUDA tensor on "
                             f"{x.device}, got {t.device}")
    Bx, N, d = x.shape
    B, K = mu.shape[0], mu.shape[1]
    if mu.shape[2] != d or var.shape != mu.shape or pi.shape != (B, K):
        raise ValueError(f"gmm_estep: shapes x {tuple(x.shape)}, mu "
                         f"{tuple(mu.shape)}, var {tuple(var.shape)}, pi "
                         f"{tuple(pi.shape)} do not agree")
    if Bx == 0 or B % Bx:
        raise ValueError(f"gmm_estep: batch {B} must be a multiple of the "
                         f"{Bx} shared feature blocks")
    if B > _MAX_GRID_Y or min(N, K, d) < 1:
        raise ValueError(f"gmm_estep: need 1 ≤ B ≤ {_MAX_GRID_Y} and "
                         f"N, K, d ≥ 1, got B={B} N={N} K={K} d={d}")
    inv = (1.0 / var).contiguous()
    muinv = (mu * inv).contiguous()
    const = (pi.clamp_min(1e-20).log()
             - 0.5 * (d * _LOG2PI + var.log().sum(-1)
                      + (mu.square() * inv).sum(-1))).contiguous()
    out = torch.empty((B, N, K), dtype=torch.float32, device=x.device)
    lse = torch.empty((B, N), dtype=torch.float32, device=x.device) \
        if fused else None
    status = _lib().estep_launch(
        x.data_ptr(), inv.data_ptr(), muinv.data_ptr(), const.data_ptr(),
        out.data_ptr(), lse.data_ptr() if fused else None,
        Bx, B, N, K, d, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, "estep_launch")
    LAUNCHES["estep_fused" if fused else "estep"] += 1
    return out, lse


def estep(x: torch.Tensor, mu: torch.Tensor, var: torch.Tensor,
          pi: torch.Tensor) -> torch.Tensor:
    """log[π_k N(x_n | μ_k, diag Σ_k)]: (N, d) × (K, d) → (N, K).

    ``var`` is diag (K, d) or spher (K,).  Matches ``ref.estep_ref``.
    """
    if mu.dim() != 2:
        raise ValueError(f"estep is single-fit (got mu {tuple(mu.shape)}); "
                         "use estep_fused")
    _, xb, mub, varb, pib = _prep(x, mu, var, pi)
    out, _ = _launch(xb, mub, varb, pib, fused=False)
    return out[0]


def estep_fused(x: torch.Tensor, mu: torch.Tensor, var: torch.Tensor,
                pi: torch.Tensor):
    """Fused batched E-step: (log-numerators, row logsumexp).

    x: (Bx, N, d) or (N, d); mu: (B, K, d) or (K, d) with B % Bx == 0 —
    each run of B // Bx consecutive fits shares one feature block.  var:
    diag (…, K, d) or spher (…, K).  Returns ((B, N, K), (B, N)), or
    ((N, K), (N,)) for unbatched inputs.  Matches ``ref.estep_fused_ref``.
    """
    batched, xb, mub, varb, pib = _prep(x, mu, var, pi)
    out, lse = _launch(xb, mub, varb, pib, fused=True)
    if not batched:
        return out[0], lse[0]
    return out, lse
