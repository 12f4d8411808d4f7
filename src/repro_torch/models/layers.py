"""Transformer blocks (port of ``repro/models/layers.py``).

Conventions as in the reference: parameters are plain dicts of tensors in
``x @ W`` layout; compute dtype is ``cfg.dtype``; norms, rotary angles and
the softmax run in f32.  Positions are per row (``Positions``): the
reference ``vmap``s a one-row decode over the server's slots, the port
runs the slots as the batch axis of one call.

Attention without a cache, and a cached call whose keys form one
contiguous range known on the host (every prefill), go through
``kernels.ops.attention`` (the flash kernel on the card).  The decode step
and the ring buffer's prefill chunk go through
``kernels.ops.attention_cached`` (per-row query and key positions).  On
the CPU both take their plain versions; the reference computes all of it
in XLA (``layers._sdpa_chunked``).  The cache is written in place (the
reference's arrays are immutable; here a decode step would otherwise copy
every layer's cache).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple, Union

import numpy as np
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


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """(cos, sin) of the rotary angles, (…, S, 1, D/2) for positions
    (…, S)."""
    freqs = rope_frequencies(head_dim, theta, positions.device)  # (D/2,)
    angles = positions[..., None].float() * freqs            # (…, S, D/2)
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def apply_rope(x: torch.Tensor, positions, theta: float) -> torch.Tensor:
    """x: (…, S, H, D); positions: (S,), per row (B, S), or a
    ``Positions`` (whose angles are computed once per forward).
    Split-half rotation layout."""
    if isinstance(positions, Positions):
        cos, sin = positions.rope(x.shape[-1], theta)
    else:
        cos, sin = rope_angles(positions, x.shape[-1], theta)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


@dataclasses.dataclass
class Positions:
    """Absolute positions of one forward's tokens.

    ``q`` is (B, S) on the device.  ``start`` is the first position when
    every row starts there and the host knows it (a prefill), else None
    (the server's decode, where each slot is at its own position).
    ``top`` is the largest position when the host knows it.  The rotary
    angles and the key positions of a cache are computed once per forward
    and shared by its layers (``_memo``).
    """
    q: torch.Tensor
    start: Optional[int] = None
    top: Optional[int] = None
    _memo: Dict[Tuple, object] = dataclasses.field(default_factory=dict,
                                                   repr=False)

    @classmethod
    def of(cls, positions, B: int, S: int, device) -> "Positions":
        """From None (0 … S−1), an int (the rows' shared first position),
        or each row's positions: (B, S), or (B,) for one token a row.  A
        host numpy array makes ``top`` known without a device sync."""
        if positions is None or isinstance(positions, (int, np.integer)):
            p0 = int(positions or 0)
            q = torch.arange(p0, p0 + S, device=device)
            return cls(q[None].expand(B, S), p0, p0 + S - 1)
        top = (int(positions.max()) if isinstance(positions, np.ndarray)
               else None)
        p = torch.as_tensor(positions).to(device=device, dtype=torch.long)
        p = p.reshape(B, S)           # (B,) when S == 1
        return cls(p, None, top)

    def rope(self, head_dim: int, theta: float):
        """``rope_angles`` of ``q``, shared by every layer's q and k."""
        key = ("rope", head_dim, theta)
        if key not in self._memo:
            self._memo[key] = rope_angles(self.q, head_dim, theta)
        return self._memo[key]

    def dense_kv(self, s_max: int) -> torch.Tensor:
        """(B, s_max) key positions of a dense cache: slot j holds
        position j once the row has reached it, else −1 (the
        reference's ``kv_valid = kv_pos <= positions[-1]``)."""
        key = ("dense", s_max)
        if key not in self._memo:
            j = torch.arange(s_max, device=self.q.device)[None]
            self._memo[key] = torch.where(j <= self.q[:, -1:], j, -1).to(
                torch.int32)
        return self._memo[key]

    def ring_kv(self, w: int) -> torch.Tensor:
        """(B, w) key positions of a ring after the decode write: slot j
        holds latest − ((latest − j) mod w), −1 before position 0."""
        key = ("ring", w)
        if key not in self._memo:
            j = torch.arange(w, device=self.q.device)[None]
            latest = self.q[:, -1:]
            pos = latest - torch.remainder(latest - j, w)
            self._memo[key] = torch.where(pos >= 0, pos, -1).to(torch.int32)
        return self._memo[key]

    def ring_chunk_kv(self, w: int) -> torch.Tensor:
        """(B, w + S) key positions of [old ring ∪ chunk]: before a
        chunk at p0 the ring holds p0 − w … p0 − 1 (those ≥ 0)."""
        key = ("ring_chunk", w)
        if key not in self._memo:
            j = torch.arange(w, device=self.q.device)[None]
            p0 = self.q[:, :1]
            old = p0 - 1 - torch.remainder(p0 - 1 - j, w)
            old = torch.where(old >= 0, old, -1)
            self._memo[key] = torch.cat([old, self.q], dim=1).to(torch.int32)
        return self._memo[key]

    def check_fits(self, s_max: int) -> None:
        """A dense cache holds positions 0 … s_max − 1.  The reference's
        ``dynamic_update_slice`` clamps a write past the end; the port
        raises instead."""
        if self.top is None:
            self.top = int(self.q.max())
        if self.top >= s_max:
            raise ValueError(f"KV cache overflow: position {self.top} "
                             f"past a cache of {s_max} slots")


def _write_rows(cache: torch.Tensor, pos: torch.Tensor,
                new: torch.Tensor) -> None:
    """cache[b, pos[b, s]] = new[b, s] in place, for slots that are
    distinct within each row (index_put with duplicates is undefined on
    CUDA)."""
    rows = torch.arange(cache.shape[0], device=cache.device)[:, None]
    cache[rows.expand(pos.shape), pos] = new


def attention(x: torch.Tensor, w, cfg: ModelConfig, *,
              positions: Union[torch.Tensor, Positions], window: int = 0,
              layer_cache: Optional[Dict[str, torch.Tensor]] = None
              ) -> torch.Tensor:
    """qkv projection + rope + attention + output projection.

    x: (B, S, d); positions: (S,) or a ``Positions``.  ``layer_cache``,
    when given, holds k and v (B, S_max, Hkv, D): a dense cache written
    at the tokens' positions, or a ring buffer when ``window > 0`` and
    S_max == window.  The (B, S, H, D) heads go to the kernels' (B, H, S,
    D) layout as transposed views, without a copy.
    """
    B, S, _ = x.shape
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = apply_rope((x @ w["wq"]).reshape(B, S, h, dh), positions,
                   cfg.rope_theta)
    k = apply_rope((x @ w["wk"]).reshape(B, S, hk, dh), positions,
                   cfg.rope_theta)
    v = (x @ w["wv"]).reshape(B, S, hk, dh)
    if layer_cache is None:
        o = ops.attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=cfg.causal,
                          window=window)
        return o.transpose(1, 2).reshape(B, S, h * dh) @ w["wo"]

    P = positions
    ck, cv = layer_cache["k"], layer_cache["v"]
    s_max = ck.shape[1]
    qt = q.transpose(1, 2)

    def cached(kk, vv, kv_pos):
        return ops.attention_cached(qt, kk.transpose(1, 2),
                                    vv.transpose(1, 2), P.q, kv_pos,
                                    causal=cfg.causal, window=window)
    if window > 0 and s_max == window:
        # ---- ring buffer (cache depth == window) ----
        if S == 1:
            # decode: write the one token, attend over the ring
            _write_rows(ck, torch.remainder(P.q, s_max), k)
            _write_rows(cv, torch.remainder(P.q, s_max), v)
            o = cached(ck, cv, P.ring_kv(s_max))
        else:
            # prefill chunk: attend over [old ring ∪ chunk] before
            # writing, or the write would evict keys early queries need;
            # then write the chunk's last min(S, W) tokens (the ones a
            # "last wins" scatter of all S would leave)
            o = cached(torch.cat([ck, k], dim=1), torch.cat([cv, v], dim=1),
                       P.ring_chunk_kv(s_max))
            m = min(S, s_max)
            slots = torch.remainder(P.q[:, -m:], s_max)
            _write_rows(ck, slots, k[:, -m:])
            _write_rows(cv, slots, v[:, -m:])
    else:
        P.check_fits(s_max)
        if P.start is not None:
            ck[:, P.start:P.start + S] = k
            cv[:, P.start:P.start + S] = v
        else:
            _write_rows(ck, P.q, k)
            _write_rows(cv, P.q, v)
        if P.start is not None and S > 1:
            # keys 0 … start + S − 1, queries at their tail: flash
            end = P.start + S
            o = ops.attention(qt, ck[:, :end].transpose(1, 2),
                              cv[:, :end].transpose(1, 2),
                              causal=cfg.causal, window=window)
        else:
            o = cached(ck, cv, P.dense_kv(s_max))
    return o.transpose(1, 2).reshape(B, S, h * dh) @ w["wo"]


def mlp(x: torch.Tensor, w, cfg: ModelConfig) -> torch.Tensor:
    """The encoder's GELU MLP and the dense and shared blocks' SwiGLU MLP.
    ``jax.nn.gelu`` defaults to the tanh approximation, so this does too."""
    if cfg.mlp_variant not in ("swiglu", "gelu"):
        raise NotImplementedError(
            f"mlp_variant={cfg.mlp_variant!r} is not ported yet (ROADMAP "
            "item 11: moe, vlm and relu2)")
    h = x @ w["w_in"]
    if cfg.mlp_variant == "swiglu":
        return (F.silu(x @ w["w_gate"]) * h) @ w["w_out"]
    return F.gelu(h, approximate="tanh") @ w["w_out"]
