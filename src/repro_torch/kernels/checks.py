"""Check cases of the kernels: the E-step's shapes, those of the
recurrent kernels ``wkv6`` and ``ssd``, flash attention at the wide heads,
the cache layouts of cached attention, and the norm's rows.

Shared by ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` (the norm's:
``tests/test_torch_rms_norm.py``), which hold the
CUDA kernels against their plain versions on a card, and (the shapes) by
``tests/test_torch_recurrent.py``, which holds the plain versions against
the JAX package: the check shapes, inputs drawn from a ``torch.Generator``,
and each recurrence one step at a time, as the f32 CUDA kernels run it.  A
check runs the step recurrence in float64 as the exact answer.
``replay_inputs`` draws fresh inputs for a call that ``ops.record_calls``
recorded, in the call's own layouts.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

# E-step, tag: (Bx, B, N, K, d, spher): the main path's client call (one
# feature block shared by 10 class fits of K = 10), the server's cohort
# (4 clients x 10 classes), ragged N and K with spher variances, K over
# three component tiles, K = 1, and ragged N, K and d (d % 4 != 0: the
# kernel's 4-byte copies) with few rows
ESTEP_CASES = {"main": (1, 10, 1000, 10, 1280, False),
               "cohort": (4, 40, 1000, 10, 1280, False),
               "ragged_spher": (1, 3, 1001, 7, 1280, True),
               "K=33": (2, 4, 333, 33, 128, False),
               "K=1": (1, 5, 257, 1, 96, False),
               "ragged_d_spher": (2, 6, 1001, 7, 130, True),
               "tiny": (3, 3, 5, 20, 33, False)}

# bf16 wkv6 at the path's head size against the plain version: tag, (B, H,
# T, Dh), chunk, s0 scale, lw fill.  The main path's shape (s0 = 0, as the
# path passes it) with the RWKV block's inputs; T = 200, which no chunk
# divides; and lw held at the model's clamp (-8: every decay factor of a
# chunk underflows past a few steps) and at 0 (no decay: the state and
# the outputs grow over T)
WKV6_BF16 = [("main", (64, 40, 512, 64), 64, 0.0, None),
             ("T=200", (4, 40, 200, 64), 64, 1.0, None),
             ("lw=-8", (4, 40, 512, 64), 64, 1.0, -8.0),
             ("lw=0", (4, 40, 512, 64), 64, 1.0, 0.0)]

# (B, H, T, Dh, chunk): tests/test_wkv6_kernel.py's shapes, then two with
# T % chunk != 0 (the plain version then takes one chunk of T)
WKV6_SHAPES = [(1, 2, 32, 16, 16), (2, 3, 64, 32, 16), (1, 1, 48, 64, 8),
               (2, 2, 128, 64, 32), (1, 4, 16, 8, 16),
               (1, 2, 40, 16, 16), (2, 1, 72, 32, 32)]
# (Bt, H, T, N, P, chunk): tests/test_ssd_kernel.py's shapes, then likewise
SSD_SHAPES = [(1, 2, 64, 8, 16, 32), (2, 3, 128, 16, 32, 64),
              (1, 1, 32, 4, 8, 16), (2, 1, 96, 64, 64, 32),
              (1, 2, 40, 8, 16, 16), (2, 2, 200, 16, 32, 64)]
# the paths' head sizes at a T that no chunk divides, in f32 against the
# float64 step recurrence (the plain version's one chunk of 200 f32 steps
# rounds past wkv6's 1e-4 on outputs near zero)
WKV6_LONG = (2, 2, 200, 64, 64)
SSD_LONG = (2, 2, 200, 64, 64, 256)


# flash attention at the wide heads and the widest group, tag: (B, H, Hkv,
# Sq, Sk, D, causal): pixtral-12b's prefill of 1024 image patches and 64
# tokens (D = 160), nemotron-4-340b's (D = 192), granite-34b's MQA (G = 48)
FLASH_CASES = {"pixtral_prefill": (2, 32, 8, 1088, 1088, 160, True),
               "nemotron_prefill": (2, 96, 8, 256, 256, 192, True),
               "granite34b_prefill": (2, 48, 1, 256, 256, 128, True)}
# their bf16 tolerance, |got − exp| ≤ tol·(1 + |exp|): the kernel and the
# plain version each round an f32 result to bf16, one bf16 step (2^-8
# relative) apart
FLASH_TOL_BF16 = 1e-2

# flash attention's backward, tag: (B, H, Hkv, Sq, Sk, D, causal, window,
# prefix): granite-3-2b's training shape (GQA 32 / 8, causal, S = 1024),
# hubert-xlarge's (16 / 16 heads of 80, bidirectional), pixtral-12b's as
# the smoke trains it (32 / 8 heads of 160, 4 rows of 1024 image patches
# and 1024 tokens), nemotron-4-340b's heads (96 / 8 of 192) at 2 rows of
# 512, zamba2-7b's shared block as the smoke trains it (32 / 32 heads of
# 112, 4 rows of 1024), a window, a prefix, queries at the tail of more
# keys, D = 112 and 128 with GQA, and rows before the first key (Sq > Sk,
# causal: no visible key, gradient 0)
BWD_CASES = {"granite_train": (8, 32, 8, 1024, 1024, 64, True, 0, 0),
             "hubert_train": (4, 16, 16, 512, 512, 80, False, 0, 0),
             "pixtral_train": (4, 32, 8, 2048, 2048, 160, True, 0, 0),
             "nemotron_train": (2, 96, 8, 512, 512, 192, True, 0, 0),
             "zamba2_train": (4, 32, 32, 1024, 1024, 112, True, 0, 0),
             "window": (2, 4, 2, 300, 300, 64, True, 100, 0),
             "prefix": (2, 4, 4, 200, 200, 64, True, 0, 70),
             "tail": (2, 4, 2, 70, 200, 64, True, 0, 0),
             "d112_gqa": (2, 8, 2, 200, 200, 112, True, 0, 0),
             "d128_gqa": (2, 8, 2, 200, 200, 128, True, 0, 0),
             "no_key_rows": (1, 2, 2, 100, 40, 64, True, 0, 0)}
# |got − exp| ≤ tol · max |exp| per gradient.  f32: the forward's 2e-3; the
# kernel sums in another order than the plain version (≈ 1e-6 apart).
# bf16: both sides compute in f32 from the same bf16 inputs, o and lse and
# each round its f32 gradient to bf16, so an element may differ by one bf16
# step at its own size (2^-8 relative): ≤ 4e-3 of the largest, with room
# for the f32 sums' order
BWD_TOL_F32 = 2e-3
BWD_TOL_BF16 = 1e-2


def bwd_inputs(g: torch.Generator, dev, B, H, Hkv, Sq, Sk, D, dtype):
    """q, k, v and an output gradient dO, N(0, 1) in ``dtype``; q and dO as
    (B, H, Sq, D) views of (B, Sq, H, D) tensors, the layout the model's
    activations give them."""
    def heads(h, S):
        return torch.randn(B, S, h, D, generator=g, device=dev).to(
            dtype).transpose(1, 2)
    return heads(H, Sq), heads(Hkv, Sk), heads(Hkv, Sk), heads(H, Sq)


# cached attention, tag: (B, H, Hkv, Sq, Sk, D, window, kind).  "ragged":
# a dense cache at granite-3-2b's decode, each row at its own length 1 …
# Sk; "ring": a ring of W = Sk slots with every row past W (wrapped), at
# the ring server's 4 slots; "chunk": a ring prefill chunk of Sq queries
# at pos0 > 0 over [old ring ∪ chunk]; "prefill": the ring server's own
# prefill, a whole prompt from pos0 = 0 into an empty ring (one block a
# key range: no split); then zamba2-7b's shared block at decode (Hkv =
# 32, D = 112) and yi-34b's D = 128; then the decode steps of the wide
# and grouped configs: granite-moe-3b (G = 3), pixtral-12b (D = 160, after
# its 1024 image positions), nemotron-4-340b (D = 192, G = 12),
# granite-34b (MQA: G = 48, three row blocks) and grok-1 (G = 6)
CACHED_CASES = {"granite_decode": (8, 32, 8, 1, 1024, 64, 0, "ragged"),
                "ring_wrap": (4, 32, 8, 1, 128, 64, 128, "ring"),
                "ring_chunk": (2, 32, 8, 64, 128, 64, 128, "chunk"),
                "ring_prefill": (1, 32, 8, 300, 128, 64, 128, "prefill"),
                "zamba2_decode": (4, 32, 32, 1, 640, 112, 0, "ragged"),
                "d128_gqa": (2, 8, 2, 5, 300, 128, 0, "ragged"),
                "granite_moe_decode": (8, 24, 8, 1, 1024, 64, 0, "ragged"),
                "pixtral_decode": (4, 32, 8, 1, 1152, 160, 0, "ragged"),
                "nemotron_decode": (4, 96, 8, 1, 512, 192, 0, "ragged"),
                "granite34b_decode": (4, 48, 1, 1, 512, 128, 0, "ragged"),
                "grok_decode": (4, 48, 8, 1, 512, 128, 0, "ragged")}


def cached_inputs(g: torch.Generator, dev, B, H, Hkv, Sq, Sk, D, window,
                  kind, dtype=torch.float32):
    """(q (B, H, Sq, D), k, v (B, Hkv, S_keys, D) as (B, S, Hkv, D)
    transposed like a cache, q_pos (B, Sq), kv_pos (B, S_keys)) for a
    case of ``CACHED_CASES``; a "chunk" or "prefill" has S_keys =
    Sk + Sq."""
    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)
    rows = torch.arange(B, device=dev)[:, None]
    j = torch.arange(Sk, device=dev)[None]
    if kind == "ragged":
        length = torch.linspace(1, Sk, B, device=dev).round().long()[:, None]
        q_pos = length - 1 + torch.arange(Sq, device=dev)[None] - (Sq - 1)
        kv_pos = torch.where(j < length, j, -1)
    elif kind == "ring":
        latest = Sk + 7 * rows + 3 * Sk * (rows % 2)
        q_pos = latest
        kv_pos = latest - torch.remainder(latest - j, Sk)
    elif kind in ("chunk", "prefill"):
        # a chunk: some old slots still empty; a prefill: all of them
        p0 = Sk // 2 + 9 * rows if kind == "chunk" else 0 * rows
        q_pos = p0 + torch.arange(Sq, device=dev)[None]
        old = p0 - 1 - torch.remainder(p0 - 1 - j, Sk)
        kv_pos = torch.cat([torch.where(old >= 0, old, -1), q_pos], 1)
    else:
        raise ValueError(kind)
    n_keys = kv_pos.shape[1]
    q = rnd(B, Sq, H, D).transpose(1, 2)
    k, v = (rnd(B, n_keys, Hkv, D).transpose(1, 2) for _ in range(2))
    return q, k, v, q_pos.int(), kv_pos.int()


# the one-pass RMS norm, tag: (rows, d, dtype, gated): the benchmark's
# rows (hubert-xlarge's 256 clips of 64 frames, zamba2-7b's 256 documents
# of 128 tokens: its ln and its gated norm over d_inner), 16 decode rows,
# f32 (at nemotron-4-340b's width the row waits in shared memory) and an
# odd width (one value a load).  The first three are timed.
RMS_NORM_CASES = {"d1280": (16384, 1280, torch.bfloat16, False),
                  "d3584": (32768, 3584, torch.bfloat16, False),
                  "gated_d7168": (32768, 7168, torch.bfloat16, True),
                  "decode_d1280": (16, 1280, torch.bfloat16, False),
                  "decode_gated": (16, 7168, torch.bfloat16, True),
                  "f32_d3584": (4096, 3584, torch.float32, False),
                  "f32_gated": (4096, 7168, torch.float32, True),
                  "f32_smem": (16, 18432, torch.float32, False),
                  "odd": (300, 1283, torch.bfloat16, True)}
RMS_NORM_TIMED = ("d1280", "d3584", "gated_d7168")


def rms_norm_inputs(g: torch.Generator, dev, rows, d, dtype, gated=False):
    """(x, gamma, z or None): x (rows, d) ~ 3 N(0, 1), gamma ~ 1 + 0.1
    N(0, 1), and z the first d columns of a (rows, 2 d + 240) tensor, as
    the Mamba2 gate is a split view of the in-projection."""
    x = torch.randn(rows, d, generator=g, device=dev).mul_(3.0).to(dtype)
    gamma = (1.0 + 0.1 * torch.randn(d, generator=g, device=dev)).to(dtype)
    if not gated:
        return x, gamma, None
    proj = torch.randn(rows, 2 * d + 240, generator=g, device=dev)
    return x, gamma, proj.mul_(2.0).to(dtype)[:, :d]


def bf16_steps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """How many bf16 steps apart two bf16 tensors are, value by value (the
    bit patterns as integers in the order of the values)."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (ordered(got) - ordered(want)).abs()


def estep_inputs(g: torch.Generator, dev, Bx, B, N, K, d, spher=False):
    """(x (Bx, N, d), mu (B, K, d), var diag (B, K, d) or spher (B, K),
    pi (B, K)), f32."""
    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev)
    x, mu = rnd(Bx, N, d), rnd(B, K, d)
    var = F.softplus(rnd(*((B, K) if spher else (B, K, d)))) + 0.1
    return x, mu, var, torch.softmax(rnd(B, K), -1)


def wkv6_inputs(g: torch.Generator, dev, B, H, T, Dh, dtype=torch.float32,
                s0_scale=1.0, model_like=False, lw_fill=None):
    """(r, k, v, lw, u, s0): r, k, v in ``dtype``; lw ≤ 0, u, s0 in f32.
    ``model_like`` lays r, k, v, lw out as the RWKV block passes them
    ((B, T, H, Dh) transposed) with lw = −exp(w0 + δ), w0 = −0.6, clamped
    to [−8, 0]; ``lw_fill`` then holds lw at that value."""
    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev)
    if model_like:
        r, k, v = (rnd(B, T, H, Dh).to(dtype).transpose(1, 2)
                   for _ in range(3))
        lw = (-torch.exp(-0.6 + 0.3 * rnd(B, T, H, Dh))).clamp(-8.0, 0.0)
        if lw_fill is not None:
            lw = torch.full_like(lw, lw_fill)
        lw = lw.transpose(1, 2)
    else:
        r, k, v = (rnd(B, H, T, Dh).to(dtype) for _ in range(3))
        lw = -F.softplus(rnd(B, H, T, Dh))
    return r, k, v, lw, 0.5 * rnd(H, Dh), s0_scale * rnd(B, H, Dh, Dh)


def ssd_inputs(g: torch.Generator, dev, Bt, H, T, N, P, dtype=torch.float32,
               s0_scale=1.0, model_like=False, a_fill=None):
    """(x, a_log, B, C, s0): x, B, C in ``dtype``; a_log ≤ 0 and s0 in
    f32.  ``model_like`` lays x and a_log out as the Mamba2 block passes
    them ((Bt, T, H, ·) transposed) with a_log = Δ·A for Δ in [1e-3, 0.1]
    and A = −1 (A_log = 0); ``a_fill`` then holds a_log at that value."""
    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev)
    if model_like:
        x = rnd(Bt, T, H, P).to(dtype).transpose(1, 2)
        a = -(1e-3 + 0.099 * torch.rand(Bt, T, H, generator=g, device=dev))
        if a_fill is not None:
            a = torch.full_like(a, a_fill)
        a = a.transpose(1, 2)
    else:
        x = rnd(Bt, H, T, P).to(dtype)
        a = -0.2 * F.softplus(rnd(Bt, H, T))
    Bm, Cm = (rnd(Bt, T, N).to(dtype) for _ in range(2))
    return x, a, Bm, Cm, s0_scale * rnd(Bt, H, N, P)


# the recurrences' backward kernels, tag: (kernel, dims, chunk, s0 and
# dS_T scale, decay fill: lw for wkv6, a_log for ssd): rwkv6-3b's and
# zamba2-7b's training shapes as the blocks pass them (s0 = 0 and the
# final-state gradient None: zero, as in training), then the other head and
# state sizes, T that no tile of 16 divides, lw at the model's clamp (over
# T = 100, and over 16 of the bf16 kernel's chunks of 64, the last ragged at
# 40 steps) and a_log ≡ −2, far past Mamba2's init range, with s0 and dS_T
# nonzero.  ``chunk`` is the plain chunked version's, for the comparison
# with its autograd: one that divides T, and 10 at lw = −8 (the chunked
# VJP's masked exponents reach e^{+8(C−1)}: past a chunk of 12 they
# overflow and make dlw NaN, tests/test_torch_recurrent_bwd.py), 8 at
# a_log = −2 (they reach e^{2(C−1)})
RECUR_BWD_CASES = {"rwkv6_train": ("wkv6", (8, 40, 1024, 64), 64, 0.0, None),
                   "zamba2_train": ("ssd", (4, 112, 1024, 64, 64), 256, 0.0,
                                    None),
                   "wkv6_T=200": ("wkv6", (2, 4, 200, 64), 40, 1.0, None),
                   "wkv6_lw=-8": ("wkv6", (2, 4, 100, 64), 10, 1.0, -8.0),
                   "wkv6_T=1000_lw=-8": ("wkv6", (1, 2, 1000, 64), 10, 1.0,
                                         -8.0),
                   "wkv6_dh32": ("wkv6", (2, 3, 37, 32), 16, 1.0, None),
                   "wkv6_dh16": ("wkv6", (1, 5, 50, 16), 16, 1.0, None),
                   "wkv6_dh8": ("wkv6", (3, 2, 19, 8), 8, 1.0, None),
                   "ssd_T=65": ("ssd", (2, 8, 65, 64, 64), 64, 1.0, None),
                   "ssd_N32_P40": ("ssd", (2, 3, 70, 32, 40), 32, 1.0, None),
                   "ssd_N16_P32": ("ssd", (1, 4, 33, 16, 32), 16, 1.0, None),
                   "ssd_N4_P8": ("ssd", (2, 3, 21, 4, 8), 8, 1.0, None),
                   "ssd_N8_P16": ("ssd", (1, 2, 1, 8, 16), 8, 1.0, None),
                   "ssd_a=-2": ("ssd", (2, 4, 200, 64, 64), 8, 1.0, -2.0)}
# |got − exp| ≤ tol · max |exp| per gradient.  f32: both sides sum in f32
# in their own orders (dlw and da_log by the prefix sum against the direct
# formula).  bf16: both compute in f32 from the same bf16 inputs and round
# dr, dk, dv (dx, dB, dC) to bf16, one bf16 step (2^-8 relative) apart
RECUR_BWD_TOL_F32 = 1e-3
RECUR_BWD_TOL_BF16 = 1e-2


def recur_bwd_inputs(g: torch.Generator, dev, kernel, dims, dtype, scale,
                     fill=None):
    """(the forward's inputs, the output gradient, the final-state
    gradient or None) of a ``RECUR_BWD_CASES`` case: the inputs as the
    blocks lay them out (``model_like``, the decay held at ``fill`` when
    given), the output gradient as a
    (·, ·, T, ·) view of a (·, T, ·, ·) tensor in ``dtype``, the final-state
    gradient N(0, scale²) in f32, None when scale is 0."""
    if kernel == "wkv6":
        args = wkv6_inputs(g, dev, *dims, dtype, scale, model_like=True,
                           lw_fill=fill)
        state = args[5].shape
    else:
        args = ssd_inputs(g, dev, *dims, dtype, scale, model_like=True,
                          a_fill=fill)
        state = args[4].shape
    x = args[0]
    B, H, T, D = x.shape
    dout = torch.randn(B, T, H, D, generator=g, device=dev).to(
        dtype).transpose(1, 2)
    dS = (scale * torch.randn(*state, generator=g, device=dev)
          if scale else None)
    return args, dout, dS


def wkv6_steps(r, k, v, lw, u, s0):
    """The WKV6 recurrence one step at a time, in the inputs' dtype."""
    S = s0.clone()
    outs = []
    for t in range(r.shape[2]):
        kv = k[:, :, t, :, None] * v[:, :, t, None, :]
        outs.append(torch.einsum("bhd,bhde->bhe", r[:, :, t],
                                 S + u[None, :, :, None] * kv))
        S = torch.exp(lw[:, :, t])[..., None] * S + kv
    return torch.stack(outs, dim=2), S


def ssd_steps(x, a_log, B, C, s0):
    """The SSD recurrence one step at a time, in the inputs' dtype."""
    S = s0.clone()
    ys = []
    for t in range(x.shape[2]):
        S = torch.exp(a_log[:, :, t])[..., None, None] * S \
            + B[:, None, t, :, None] * x[:, :, t, None, :]
        ys.append(torch.einsum("bn,bhnp->bhp", C[:, t], S))
    return torch.stack(ys, dim=2), S


# one MoE layer at full width, f32, on the card against the CPU: tag:
# (config, tokens) (granite-moe-3b's 40 experts, top 8, at one group of
# 256 tokens: capacity 80)
MOE_CASES = {"granite_moe": ("granite-moe-3b-a800m", 256)}


def moe_inputs(g: torch.Generator, cfg, T: int):
    """(x (1, T, d), one layer's MoE weights in ``init_moe``'s law), f32
    on the CPU, drawn from ``g``."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts

    def dense(*shape):
        return torch.randn(*shape, generator=g) / shape[-2] ** 0.5
    w = {"router": dense(d, E), "we_in": dense(E, d, ff),
         "we_out": dense(E, ff, d)}
    if cfg.mlp_variant == "swiglu":
        w["we_gate"] = dense(E, d, ff)
    return torch.randn(1, T, d, generator=g), w


def moe_run(cfg, x, w):
    """One ``layers.moe`` call: (y, the routes (T, K), dropped
    assignments)."""
    from repro_torch.models import layers
    with layers.record_moe() as rec:
        y, _ = layers.moe(x, w, cfg)
    _, _, top_idx = layers.route(x.reshape(-1, x.shape[-1]), w["router"],
                                 cfg.top_k)
    return y, top_idx, int(sum(dropped for _, dropped, _ in rec))


def strided_like(spec, values: torch.Tensor) -> torch.Tensor:
    """``values`` copied into a fresh tensor with the layout of ``spec``
    (an ``ops.TensorSpec``): its shape, strides, dtype and misalignment.
    A dim of stride 0 (a broadcast) takes the values at its index 0."""
    need = 1 + sum((n - 1) * st for n, st in zip(spec.shape, spec.stride)
                   if n > 0)
    base = torch.empty(spec.offset + need, dtype=spec.dtype,
                       device=values.device)
    own = tuple(1 if st == 0 else n for n, st in zip(spec.shape,
                                                     spec.stride))
    base.as_strided(own, spec.stride, spec.offset).copy_(
        values[tuple(slice(0, n) for n in own)])
    return base.as_strided(spec.shape, spec.stride, spec.offset)


def replay_inputs(call, g: torch.Generator, dev):
    """Fresh inputs for a recorded ``ops.Call``, in the call's own layouts:
    attention's q, k, v N(0, 1); cached attention's with the call's
    positions; the recurrences' in the blocks' laws (``wkv6_inputs`` /
    ``ssd_inputs`` with ``model_like``), s0 N(0, 0.25²).  A backward's
    record (``<name>_bwd``) replays its forward's inputs."""
    specs = call.tensors
    name = call.name.removesuffix("_bwd")

    def rnd(spec):
        return torch.randn(spec.shape, generator=g, device=dev)
    if name == "attention":
        vals = [rnd(s) for s in specs]
    elif name == "attention_cached":
        vals = [rnd(s) for s in specs[:3]] + [p.to(dev)
                                              for p in call.positions]
    elif name == "wkv6":
        B, H, T, Dh = specs[0].shape
        r, k, v, lw, u, s0 = wkv6_inputs(g, dev, B, H, T, Dh, model_like=True)
        vals = [r, k, v, lw, u, 0.25 * s0]
    elif name == "ssd":
        Bt, H, T, P = specs[0].shape
        N = specs[2].shape[-1]
        x, a, Bm, Cm, s0 = ssd_inputs(g, dev, Bt, H, T, N, P,
                                      model_like=True)
        vals = [x, a, Bm, Cm, 0.25 * s0]
    else:
        raise ValueError(call.name)
    return [strided_like(s, v) for s, v in zip(specs, vals)]
