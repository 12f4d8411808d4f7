"""Plain float32 forwards of the benchmark's backbones, with the feature map.

Independent of the program: plain ``torch`` operations written from the
equations, reading the weights the benchmark made (a dict in the layout the
program serves: per-layer weights stacked on a leading (L, ...) axis, ``x @ W``
orientation).  Every layer's weights are cast to float32 one layer at a time,
so a reference of zamba2-7b needs one layer's float32 copy beside the bf16
weights, and TF32 is off.

Families:

  encoder - frames (B, S, F) @ frame_proj; L blocks of pre-norm bidirectional
            attention with rotary positions and a GELU (tanh) MLP
  hybrid  - token embedding; L Mamba2 layers, and after every
            ``attn_every``-th one shared causal attention + SwiGLU block

``features`` is the final RMS norm's output mean-pooled over the positions
that ``valid`` marks (all of them without it), in float32.

``mm`` replaces every weight product ``x @ W`` (the control runs the same
reference through a lower-precision product, ``fp8_matmul``).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

MatMul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
NORM_EPS = 1e-6
DT_MIN, DT_MAX = 1e-3, 1e-1


def f32_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale for the whole tensor
    (its largest magnitude maps to e4m3's largest, 448), back in float32."""
    amax = t.abs().amax().clamp_min(1e-12)
    scale = 448.0 / amax
    return (t * scale).to(torch.float8_e4m3fn).float() / scale


def fp8_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The product of both operands rounded to float8 e4m3, accumulated in
    float32: the precision one step below the configured bfloat16."""
    return _fp8(x) @ _fp8(w)


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rms_norm(x: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + NORM_EPS) \
        * gamma


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Split-half rotary embedding of x (B, S, H, D) at positions 0 ... S-1."""
    S, D = x.shape[1], x.shape[-1]
    half = D // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                         device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(x: torch.Tensor, w: Dict, cfg: Dict, mm: MatMul,
              causal: bool) -> torch.Tensor:
    B, S, _ = x.shape
    H, Hk, D = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    q = rope(mm(x, w["wq"]).reshape(B, S, H, D), cfg["rope_theta"])
    k = rope(mm(x, w["wk"]).reshape(B, S, Hk, D), cfg["rope_theta"])
    v = mm(x, w["wv"]).reshape(B, S, Hk, D)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    if Hk != H:
        k = k.repeat_interleave(H // Hk, dim=1)
        v = v.repeat_interleave(H // Hk, dim=1)
    s = q @ k.transpose(-1, -2) / math.sqrt(D)
    if causal:
        keep = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    o = torch.softmax(s, dim=-1) @ v
    return mm(o.transpose(1, 2).reshape(B, S, H * D), w["wo"])


def mlp(x: torch.Tensor, w: Dict, variant: str, mm: MatMul) -> torch.Tensor:
    h = mm(x, w["w_in"])
    if variant == "swiglu":
        h = F.silu(mm(x, w["w_gate"])) * h
    elif variant == "gelu":
        h = F.gelu(h, approximate="tanh")
    elif variant == "relu2":
        h = torch.relu(h).square()
    else:
        raise ValueError(f"unknown MLP variant {variant!r}")
    return mm(h, w["w_out"])


def transformer_block(x, w, cfg, mm, causal):
    x = x + attention(rms_norm(x, w["ln1"]), w, cfg, mm, causal)
    return x + mlp(rms_norm(x, w["ln2"]), w, cfg["mlp_variant"], mm)


def ssd(x: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor) -> torch.Tensor:
    """y_t = sum_{s<=t} exp(A_t - A_s) (C_t . B_s) x_s from a zero state, with
    A_t the running sum of the log decays a.  x (Bt, H, T, P), a (Bt, H, T),
    Bm, Cm (Bt, T, N) shared by the heads; the quadratic form of
    S_t = exp(a_t) S_{t-1} + B_t x_t^T, y_t = C_t^T S_t."""
    T = x.shape[2]
    cum = torch.cumsum(a, dim=-1)
    seg = cum[..., :, None] - cum[..., None, :]              # (Bt, H, T, T)
    keep = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(seg.masked_fill(~keep, float("-inf")))
    cb = Cm @ Bm.transpose(1, 2)                             # (Bt, T, T)
    return (decay * cb[:, None]) @ x


def mamba_block(x: torch.Tensor, w: Dict, cfg: Dict, mm: MatMul):
    Bt, T, d = x.shape
    d_inner = cfg["ssm_expand"] * d
    P, N = cfg["ssm_head_dim"], cfg["ssm_state"]
    H = d_inner // P
    proj = mm(rms_norm(x, w["ln"]), w["w_in"])
    z, xi, Bv, Cv, dt_raw = torch.split(proj, [d_inner, d_inner, N, N, H],
                                        dim=-1)
    conv_in = torch.cat([xi, Bv, Cv], dim=-1)
    Kw = cfg["conv_width"]
    padded = F.pad(conv_in, (0, 0, Kw - 1, 0))
    conv = sum(padded[:, i:i + T] * w["conv_w"][i] for i in range(Kw))
    conv = F.silu(conv + w["conv_b"])
    xi, Bv, Cv = torch.split(conv, [d_inner, N, N], dim=-1)
    dt = F.softplus(dt_raw + w["dt_bias"]).clamp(DT_MIN, DT_MAX)
    a = (dt * -torch.exp(w["A_log"])).transpose(1, 2)        # (Bt, H, T)
    xh = xi.reshape(Bt, T, H, P).transpose(1, 2)             # (Bt, H, T, P)
    y = ssd(xh * dt.transpose(1, 2)[..., None], a, Bv, Cv)
    y = y + w["D"][None, :, None, None] * xh
    y = y.transpose(1, 2).reshape(Bt, T, d_inner)
    y = rms_norm(y, w["gn"]) * F.silu(z)
    return x + mm(y, w["w_out"])


def _layer(stack: Dict, i: int) -> Dict:
    return {k: v[i].float() for k, v in stack.items()}


def hidden(cfg: Dict, params: Dict, inputs: torch.Tensor,
           mm: MatMul = f32_matmul) -> torch.Tensor:
    """Final-norm hidden states (B, S, d) in float32.  ``inputs``: frames
    (B, S, F) for the encoder, token ids (B, S) otherwise."""
    family = cfg["family"]
    if family == "encoder":
        x = mm(inputs.float(), params["frame_proj"].float())
        for i in range(cfg["n_layers"]):
            x = transformer_block(x, _layer(params["blocks"], i), cfg, mm,
                                  causal=False)
    elif family == "hybrid":
        x = params["embed"][inputs.long()].float()
        shared = {k: v.float() for k, v in params["shared_attn"].items()}
        for i in range(cfg["n_layers"]):
            x = mamba_block(x, _layer(params["blocks"], i), cfg, mm)
            if (i + 1) % cfg["attn_every"] == 0:
                x = transformer_block(x, shared, cfg, mm, causal=True)
    else:
        raise ValueError(f"no reference for family {family!r}")
    return rms_norm(x, params["final_norm"].float())


@torch.no_grad()
def features(cfg: Dict, params: Dict, inputs: torch.Tensor,
             valid: Optional[torch.Tensor] = None,
             mm: MatMul = f32_matmul) -> torch.Tensor:
    """(B, d) float32: the hidden states mean-pooled over ``valid``'s
    positions (B, S), or over all of them."""
    no_tf32()
    h = hidden(cfg, params, inputs, mm)
    if valid is None:
        return h.mean(dim=1)
    m = valid.to(h.dtype)[..., None]
    return (h * m).sum(1) / m.sum(1).clamp_min(1.0)
