"""RWKV6 ("Finch") blocks (port of ``repro/models/rwkv.py``).

Recurrence per head, state S ∈ R^{Dh×Dh}:
    out_t = r_tᵀ (S_{t−1} + diag(u) k_t v_tᵀ)
    S_t   = diag(w_t) S_{t−1} + k_t v_tᵀ        w_t = exp(lw_t), lw_t ≤ 0

The recurrence goes through ``kernels.ops.wkv6``: the hand-written kernel
on the card, the plain chunked version on the CPU (the reference calls its
XLA ``wkv6_chunked`` here and never its Pallas kernel), from the state's
``S`` (zeros for features, the cache's for a prefill with state).  A
single decode step is ``wkv6_decode``, plain torch as the reference's XLA
(one step is a rank-one update, no kernel).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_stack, rms_norm

LW_MIN = -8.0  # clamp per-step log-decay (w ≥ e^-8): numerics guard
LORA = 64
F32_LEAVES = ("w0", "u")   # held in f32 whatever cfg.dtype is


def init_rwkv_block(cfg: ModelConfig, n_layers: int, dtype,
                    generator: torch.Generator, device) -> Dict:
    """Stacked (L, …) RWKV6 weights, the law of the reference's
    ``init_rwkv_block``, drawn one layer at a time (``dense_stack``)."""
    d, H, Dh, ff = cfg.d_model, cfg.n_heads, cfg.ssm_head_dim, cfg.d_ff
    L = n_layers

    def full(shape, value, dt=dtype):
        return torch.full((L,) + shape, value, dtype=dt, device=device)

    def dense(shape, dt=dtype, scale=None):
        return dense_stack(L, shape, dt, generator, device, scale)
    return {
        "ln1": full((d,), 1.0),
        "ln2": full((d,), 1.0),
        "mix_r": full((d,), 0.5),
        "mix_k": full((d,), 0.5),
        "mix_v": full((d,), 0.5),
        "mix_w": full((d,), 0.5),
        "wr": dense((d, d)),
        "wk": dense((d, d)),
        "wv": dense((d, d)),
        "wg": dense((d, d)),
        "wo": dense((d, d)),
        "w0": full((d,), -0.6, torch.float32),
        "wA1": dense((d, LORA)),
        "wA2": dense((LORA, d), scale=0.01),
        "u": dense((H, Dh), torch.float32, scale=0.5),
        "gn": full((d,), 1.0),
        "mix_c": full((d,), 0.5),
        "wc_in": dense((d, ff)),
        "wc_out": dense((ff, d)),
    }


def wkv6_decode(r, k, v, lw, u, s0):
    """Single-token WKV6.  r, k, v, lw: (B, H, Dh); u: (H, Dh); s0:
    (B, H, Dh, Dh) → (out in r's dtype, new state f32)."""
    rc, kc, vc, lwc = (a.float() for a in (r, k, v, lw))
    uf = u.float()
    out = torch.einsum("bhd,bhde->bhe", rc, s0.float()) \
        + torch.einsum("bhd,hd,bhd,bhe->bhe", rc, uf, kc, vc)
    S = torch.exp(lwc)[..., None] * s0 + kc[..., None] * vc[..., None, :]
    return out.to(r.dtype), S


def _token_shift(x: torch.Tensor, last_x: torch.Tensor) -> torch.Tensor:
    """x: (B, T, d); last_x: (B, d) from the previous step → x_{t−1}."""
    return torch.cat([last_x[:, None, :], x[:, :-1, :]], dim=1)


def rwkv_block(cfg: ModelConfig, x: torch.Tensor, w, state, *,
               use_cache: bool = False):
    """One RWKV6 layer, x: (B, T, d); state: dict(sx_tm, sx_cm, S).  A
    one-token step with ``use_cache`` is the decode step."""
    B, T, d = x.shape
    H, Dh = cfg.n_heads, cfg.ssm_head_dim
    # ---- time mix ----
    xn = rms_norm(x, w["ln1"])
    prev = _token_shift(xn, state["sx_tm"].to(xn.dtype))

    def lerp(mix):
        return xn + (prev - xn) * mix

    def heads(a):                   # (B, T, d) → (B, H, T, Dh) view
        return a.reshape(B, T, H, Dh).transpose(1, 2)
    xr = lerp(w["mix_r"])
    r = heads(xr @ w["wr"])
    k = heads(lerp(w["mix_k"]) @ w["wk"])
    v = heads(lerp(w["mix_v"]) @ w["wv"])
    g = F.silu(xr @ w["wg"])
    xw = lerp(w["mix_w"])
    lw = -torch.exp(w["w0"].float()
                    + torch.tanh(xw @ w["wA1"]).float() @ w["wA2"].float())
    lw = heads(lw.clamp(LW_MIN, 0.0))
    if T == 1 and use_cache:
        o, S = wkv6_decode(r[:, :, 0], k[:, :, 0], v[:, :, 0], lw[:, :, 0],
                           w["u"], state["S"])
        o = o[:, :, None]
    else:
        o, S = ops.wkv6(r, k, v, lw, w["u"], state["S"],
                        chunk=cfg.chunk_size)
    o = o.transpose(1, 2).reshape(B, T, d)
    o = rms_norm(o, w["gn"]) * g
    x = x + o @ w["wo"]

    # ---- channel mix ----
    xn2 = rms_norm(x, w["ln2"])
    prev2 = _token_shift(xn2, state["sx_cm"].to(xn2.dtype))
    xc = xn2 + (prev2 - xn2) * w["mix_c"]
    h = torch.square(torch.relu(xc @ w["wc_in"]))
    x = x + h @ w["wc_out"]
    new_state = {"sx_tm": xn[:, -1, :].float(),
                 "sx_cm": xn2[:, -1, :].float(), "S": S}
    return x, new_state


def init_rwkv_state(cfg: ModelConfig, batch: int, device,
                    n_layers: Optional[int] = None
                    ) -> Dict[str, torch.Tensor]:
    """Zero state of ``n_layers`` (default ``cfg.n_layers``) layers."""
    d, H, Dh = cfg.d_model, cfg.n_heads, cfg.ssm_head_dim
    n_layers = cfg.n_layers if n_layers is None else n_layers
    z = dict(dtype=torch.float32, device=device)
    return {"sx_tm": torch.zeros((n_layers, batch, d), **z),
            "sx_cm": torch.zeros((n_layers, batch, d), **z),
            "S": torch.zeros((n_layers, batch, H, Dh, Dh), **z)}
