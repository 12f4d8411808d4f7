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

import contextlib
import dataclasses
import math
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.kernels import ops, ref
from repro_torch.models.config import ModelConfig


def dense_init(shape, dtype, generator: torch.Generator, device,
               scale: Optional[float] = None) -> torch.Tensor:
    """N(0, 1)·scale with scale 1/√fan_in (fan_in = shape[-2]), the law of
    the reference's ``dense_init``."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = (1.0 / math.sqrt(fan_in)) if scale is None else scale
    z = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return z.mul_(scale).to(dtype)


def dense_stack(n_layers: int, shape, dtype, generator: torch.Generator,
                device, scale: Optional[float] = None) -> torch.Tensor:
    """(n_layers, *shape) weights of ``dense_init``'s law, drawn one layer
    at a time so that no f32 temporary exceeds one layer's matrix."""
    out = torch.empty((n_layers,) + tuple(shape), dtype=dtype, device=device)
    for layer in range(n_layers):
        out[layer] = dense_init(tuple(shape), dtype, generator, device, scale)
    return out


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6,
             z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """RMS norm over the last dim in f32, cast to x's dtype; with the gate
    ``z``, times silu(z) (Mamba2's gated norm).  Without a gradient wanted
    ``ops.rms_norm`` (the one-pass kernel on the card); with one, the plain
    expression, whose rows on the card count under
    ``model.rms_norm.plain_rows``."""
    if not (torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, gamma, z))):
        return ops.rms_norm(x, gamma, z, eps=eps)
    if x.is_cuda:
        obs.count("model.rms_norm.plain_rows", x.numel() // x.shape[-1])
    return ref.rms_norm_ref(x, gamma, z, eps=eps)


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
    """The dense MLP: SwiGLU (three matrices), squared ReLU (``relu2``, two)
    or GELU (two).  ``jax.nn.gelu`` defaults to the tanh approximation, so
    this does too."""
    h = x @ w["w_in"]
    if cfg.mlp_variant == "swiglu":
        h = F.silu(x @ w["w_gate"]) * h
    else:
        h = _activation(h, cfg.mlp_variant)
    return h @ w["w_out"]


def _activation(h: torch.Tensor, variant: str) -> torch.Tensor:
    if variant == "relu2":
        return torch.relu(h).square()
    if variant == "gelu":
        return F.gelu(h, approximate="tanh")
    raise ValueError(variant)


# While ``record_moe`` is active, a list: each ``moe`` call appends its
# (assignments, dropped assignments, per_row), the second a device tensor
# (no sync).
_MOE_RECORD: Optional[List[Tuple[int, torch.Tensor, bool]]] = None


@contextlib.contextmanager
def record_moe():
    """Collect the (token, expert) assignments and the drops of every
    ``moe`` call inside the block, and whether it grouped per row: yields
    the list they are appended to."""
    global _MOE_RECORD
    prev, _MOE_RECORD = _MOE_RECORD, []
    try:
        yield _MOE_RECORD
    finally:
        _MOE_RECORD = prev


def init_moe(cfg: ModelConfig, n_layers: int, dt,
             generator: torch.Generator, dev) -> Dict[str, torch.Tensor]:
    """Stacked (L, …) expert weights; the router stays f32 whatever the
    model's dtype (``repro/models/layers.py::init_moe``)."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    w = {"router": dense_stack(n_layers, (d, E), torch.float32, generator,
                               dev),
         "we_in": dense_stack(n_layers, (E, d, ff), dt, generator, dev),
         "we_out": dense_stack(n_layers, (E, ff, d), dt, generator, dev)}
    if cfg.mlp_variant == "swiglu":
        w["we_gate"] = dense_stack(n_layers, (E, d, ff), dt, generator, dev)
    return w


def route(xt: torch.Tensor, router: torch.Tensor, K: int):
    """Router probabilities (T, E) in f32 and each token's top K: weights
    renormalised to sum 1 and expert ids (T, K), in descending order with
    ties to the lower expert (``lax.top_k``'s order: a stable sort)."""
    probs = torch.softmax(xt.float() @ router.float(), dim=-1)
    top_w, top_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_idx = top_w[:, :K], top_idx[:, :K]
    return probs, top_w / top_w.sum(-1, keepdim=True), top_idx


def moe(x: torch.Tensor, w, cfg: ModelConfig, group_size: int = 1024,
        per_row: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mixture of experts with per-group capacity (Switch / Mesh-TF), the
    reference's ``moe``: x (B, S, d) → (y (B, S, d), aux scalar f32).

    * Routing in f32 (``route``): softmax of ``x @ router``, the top K of
      each token in descending order with ties to the lower expert,
      renormalised.
    * aux = E · Σ_e frac_tokens_e · frac_probs_e · router_aux_coef over
      all B·S tokens.
    * Groups of g = min(group_size, span) consecutive tokens (g = span
      when it does not divide span), span the B·S tokens, or each row's
      S with ``per_row`` (the server's decode: the reference ``vmap``s a
      one-row decode over its slots, so each slot is its own group).
      Capacity cap = max(K, ⌈g·K/E·capacity_factor⌉), the reference's
      float expression; an assignment's slot is the number of earlier
      assignments of its group to the same expert, token-major and
      k-minor, and it is kept when that is < cap.
    * Tokens are gathered into (E, n·cap, d) slots by index (empty slots
      zero, as the reference's one-hot product leaves them), each expert
      runs its MLP over all of its slots, and the weighted outputs are
      summed back per token in f32, k by k.  The reference's one-hot
      einsums sum one nonzero term per slot, so this is its value.
    """
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    xt = x.reshape(T, d)
    span = S if per_row else T
    g = min(group_size, span)
    if span % g:
        g = span
    n = T // g
    cap = max(K, int(math.ceil(g * K / E * cfg.capacity_factor)))

    probs, top_w, top_idx = route(xt, w["router"], K)

    counts = torch.zeros(E, dtype=torch.float32, device=x.device)
    counts.scatter_add_(0, top_idx.reshape(-1),
                        torch.ones(T * K, device=x.device))
    frac_tokens = counts / T / K
    aux = E * (frac_tokens * probs.mean(0)).sum() * cfg.router_aux_coef

    # slot of each assignment in its group's expert: the exclusive count
    # of the group's earlier assignments to that expert
    flat = top_idx.reshape(n, g * K)
    onehot = torch.zeros((n, g * K, E), dtype=torch.int32, device=x.device)
    onehot.scatter_(2, flat[..., None], 1)
    pos = (onehot.cumsum(1, dtype=torch.int32) - onehot).gather(
        2, flat[..., None])[..., 0]                          # (n, g·K)
    keep = pos < cap
    group = torch.arange(n, device=x.device)[:, None]
    trash = E * n * cap                  # the one slot dropped ones go to
    slot = torch.where(keep, (flat * n + group) * cap + pos, trash)
    slot = slot.reshape(T, K)
    if _MOE_RECORD is not None:
        _MOE_RECORD.append((T * K, (~keep).sum(), per_row))

    # gather: every kept slot is written once; the trash row is dropped
    xe = x.new_zeros((trash + 1, d))
    xe[slot] = xt[:, None].expand(T, K, d)
    xe = xe[:trash].view(E, n * cap, d)
    h = torch.bmm(xe, w["we_in"])
    if cfg.mlp_variant == "swiglu":
        h = F.silu(torch.bmm(xe, w["we_gate"])) * h
    else:
        h = _activation(h, cfg.mlp_variant)
    ye = torch.bmm(h, w["we_out"]).reshape(trash, d)

    # combine: Σ_k weight · expert output over the kept assignments, f32
    # (a dropped one reads some slot at weight 0)
    wk = top_w * keep.reshape(T, K)
    slot = slot.clamp_max(trash - 1)
    y = torch.zeros((T, d), dtype=torch.float32, device=x.device)
    for k in range(K):
        y += ye[slot[:, k]].float() * wk[:, k, None]
    return y.to(x.dtype).reshape(B, S, d), aux
