"""Mamba2 (SSD) blocks (port of ``repro/models/mamba2.py``).

Per head h with state S ∈ R^{N×P} (N = ssm_state, P = ssm_head_dim):
    S_t = a_t · S_{t−1} + (Δ_t B_t) x_tᵀ        a_t = exp(Δ_t · A_h), A_h < 0
    y_t = C_tᵀ S_t + D_h · x_t

The recurrence goes through ``kernels.ops.ssd``: the hand-written kernel on
the card, the plain chunked version on the CPU (the reference calls its XLA
``ssd_chunked`` here and never its Pallas kernel).  The operation order and
dtypes follow the reference (the conv sums its taps in ``cfg.dtype``, x·Δ
is cast to x's dtype), or bf16 parity drifts.  The conv keeps its last
conv_width − 1 inputs as state; a single decode step is ``ssd_decode``,
plain torch as the reference's XLA (one step needs no kernel).  The gated
norm ``rms_norm(y, gn) · silu(z)`` is one ``ops.rms_norm`` call, which
reads ``z`` through its split view of the in-projection.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_stack, rms_norm

DT_MIN, DT_MAX = 1e-3, 1e-1  # softplus(dt_bias + dt_raw) clamp range
F32_LEAVES = ("A_log", "dt_bias", "D")   # held in f32 whatever cfg.dtype is


def mamba_dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    P = cfg.ssm_head_dim
    H = d_inner // P
    N = cfg.ssm_state
    return d_inner, H, P, N


def init_mamba_block(cfg: ModelConfig, n_layers: int, dtype,
                     generator: torch.Generator, device) -> Dict:
    """Stacked (L, …) Mamba2 weights, the law of the reference's
    ``init_mamba_block``.  Drawn one layer at a time: zamba2-7b's whole
    (81, 3584, 14576) in-projection would be a 16.9 GB f32 temporary."""
    d = cfg.d_model
    d_inner, H, P, N = mamba_dims(cfg)
    conv_dim = d_inner + 2 * N
    L = n_layers

    def full(shape, value, dt=dtype):
        return torch.full((L,) + shape, value, dtype=dt, device=device)

    def dense(shape, scale=None):
        return dense_stack(L, shape, dtype, generator, device, scale)
    return {
        "ln": full((d,), 1.0),
        "w_in": dense((d, 2 * d_inner + 2 * N + H)),   # → [z, x, B, C, dt]
        "conv_w": dense((cfg.conv_width, conv_dim), scale=0.5),
        "conv_b": full((conv_dim,), 0.0),
        "A_log": full((H,), 0.0, torch.float32),        # A = −exp(A_log)
        "dt_bias": full((H,), -4.0, torch.float32),     # softplus ≈ 0.018
        "D": full((H,), 1.0, torch.float32),
        "gn": full((d_inner,), 1.0),
        "w_out": dense((d_inner, d)),
    }


def ssd_decode(x, a_log, B, C, s0):
    """Single-step SSD.  x: (Bt, H, P); a_log: (Bt, H); B, C: (Bt, N);
    s0: (Bt, H, N, P) → (y in x's dtype, new state f32)."""
    xf, Bf, Cf = x.float(), B.float(), C.float()
    S = torch.exp(a_log)[..., None, None] * s0 \
        + Bf[:, None, :, None] * xf[:, :, None, :]
    y = torch.einsum("bn,bhnp->bhp", Cf, S)
    return y.to(x.dtype), S


def mamba_block(cfg: ModelConfig, x: torch.Tensor, w, state, *,
                use_cache: bool = False):
    """One Mamba2 layer, x: (Bt, T, d); state: dict(conv, S) with conv
    (Bt, conv_width − 1, conv_dim) trailing inputs and S (Bt, H, N, P).
    A one-token step with ``use_cache`` is the decode step."""
    Bt, T, d = x.shape
    d_inner, H, P, N = mamba_dims(cfg)
    xn = rms_norm(x, w["ln"])
    proj = xn @ w["w_in"]
    z, xi, Bv, Cv, dt_raw = torch.split(
        proj, [d_inner, d_inner, N, N, H], dim=-1)

    # depthwise causal conv over [x, B, C]
    conv_in = torch.cat([xi, Bv, Cv], dim=-1)            # (Bt, T, conv_dim)
    Kw = cfg.conv_width
    hist = state["conv"]                               # (Bt, Kw−1, conv_dim)
    padded = torch.cat([hist.to(conv_in.dtype), conv_in], dim=1)
    kern = w["conv_w"]                                    # (Kw, conv_dim)
    conv = padded[:, 0:T] * kern[0]
    for i in range(1, Kw):
        conv = conv + padded[:, i:i + T] * kern[i]
    conv = F.silu(conv + w["conv_b"])
    new_conv = padded[:, -(Kw - 1):] if Kw > 1 else hist
    xi, Bv, Cv = torch.split(conv, [d_inner, N, N], dim=-1)

    dt = F.softplus(dt_raw.float() + w["dt_bias"])
    dt = dt.clamp(DT_MIN, DT_MAX)                         # (Bt, T, H)
    A = -torch.exp(w["A_log"])                            # (H,)
    a_log = (dt * A).transpose(1, 2)                      # (Bt, H, T)
    xh = xi.reshape(Bt, T, H, P).transpose(1, 2)          # (Bt, H, T, P)
    # fold dt into the input (standard SSD parameterization)
    xh_dt = xh * dt.transpose(1, 2)[..., None].to(xh.dtype)
    if T == 1 and use_cache:
        y, S = ssd_decode(xh_dt[:, :, 0], a_log[:, :, 0], Bv[:, 0], Cv[:, 0],
                          state["S"])
        y = y[:, :, None]
    else:
        y, S = ops.ssd(xh_dt, a_log, Bv, Cv, state["S"],
                       chunk=cfg.chunk_size)
    y = y + w["D"][None, :, None, None].to(y.dtype) * xh
    y = y.transpose(1, 2).reshape(Bt, T, d_inner)
    y = rms_norm(y, w["gn"], z=z)                         # · silu(z)
    return x + y @ w["w_out"], {"conv": new_conv, "S": S}


def init_mamba_state(cfg: ModelConfig, n_layers: int, batch: int, device
                     ) -> Dict[str, torch.Tensor]:
    d_inner, H, P, N = mamba_dims(cfg)
    conv_dim = d_inner + 2 * N
    z = dict(dtype=torch.float32, device=device)
    return {"conv": torch.zeros((n_layers, batch, cfg.conv_width - 1,
                                 conv_dim), **z),
            "S": torch.zeros((n_layers, batch, H, N, P), **z)}
