"""Transformer blocks, non-cache path (port of ``repro/models/layers.py``).

Conventions as in the reference: parameters are plain dicts of tensors in
``x @ W`` layout; compute dtype is ``cfg.dtype``; norms, rotary angles and
the softmax run in f32.  Attention goes through ``kernels.ops.attention``:
the flash kernel on the card, the plain version on the CPU (the reference
computes the same function in XLA, ``layers._sdpa_chunked``).  The decode
cache paths (dense and ring buffer) wait for the serving slice (ROADMAP).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig


def dense_init(shape, dtype, generator: torch.Generator, device,
               scale: Optional[float] = None) -> torch.Tensor:
    """N(0, 1)·scale with scale 1/√fan_in (fan_in = shape[-2]), the law of
    the reference's ``dense_init``."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = (1.0 / math.sqrt(fan_in)) if scale is None else scale
    z = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return (z * scale).to(dtype)


def dense_stack(n_layers: int, shape, dtype, generator: torch.Generator,
                device, scale: Optional[float] = None) -> torch.Tensor:
    """(n_layers, *shape) weights of ``dense_init``'s law, drawn one layer
    at a time so that no f32 temporary exceeds one layer's matrix."""
    out = torch.empty((n_layers,) + tuple(shape), dtype=dtype, device=device)
    for layer in range(n_layers):
        out[layer] = dense_init(tuple(shape), dtype, generator, device, scale)
    return out


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * gamma.float()).to(dt)


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (…, S, H, D); positions: (S,).  Split-half rotation layout."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)      # (D/2,)
    angles = positions[..., None].float() * freqs               # (S, D/2)
    cos = torch.cos(angles)[..., None, :]                       # (S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def attention(x: torch.Tensor, w, cfg: ModelConfig, *,
              positions: torch.Tensor, window: int = 0) -> torch.Tensor:
    """qkv projection + rope + attention + output projection, no cache.

    x: (B, S, d); positions: (S,).  The (B, S, H, D) heads go to the
    kernel's (B, H, S, D) layout as transposed views, without a copy.
    """
    B, S, _ = x.shape
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = apply_rope((x @ w["wq"]).reshape(B, S, h, dh), positions,
                   cfg.rope_theta)
    k = apply_rope((x @ w["wk"]).reshape(B, S, hk, dh), positions,
                   cfg.rope_theta)
    v = (x @ w["wv"]).reshape(B, S, hk, dh)
    o = ops.attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                      causal=cfg.causal, window=window)
    return o.transpose(1, 2).reshape(B, S, h * dh) @ w["wo"]


def mlp(x: torch.Tensor, w, cfg: ModelConfig) -> torch.Tensor:
    """The encoder's GELU MLP and the hybrid shared block's SwiGLU MLP.
    ``jax.nn.gelu`` defaults to the tanh approximation, so this does too."""
    if cfg.mlp_variant not in ("swiglu", "gelu"):
        raise NotImplementedError(
            f"mlp_variant={cfg.mlp_variant!r} waits for its slice (ROADMAP, "
            "port queue: serving and decoder families)")
    h = x @ w["w_in"]
    if cfg.mlp_variant == "swiglu":
        return (F.silu(x @ w["w_gate"]) * h) @ w["w_out"]
    return F.gelu(h, approximate="tanh") @ w["w_out"]
