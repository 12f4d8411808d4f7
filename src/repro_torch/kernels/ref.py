"""Plain PyTorch versions of the kernels (port of ``repro/kernels/ref.py``).

These define what each CUDA kernel must compute.  ``ops`` runs them for
tensors on the CPU; ``chip_smoke.py`` holds each kernel against them on the
card.  ``CUDA_CALLS`` counts the calls made on CUDA tensors, so a run can
show that its main path never took a plain version on the card.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

_LOG2PI = math.log(2.0 * math.pi)

CUDA_CALLS: Dict[str, int] = {"estep": 0, "estep_fused": 0, "attention": 0,
                               "attention_lse": 0, "attention_bwd": 0,
                               "attention_cached": 0, "wkv6": 0, "ssd": 0,
                               "wkv6_bwd": 0, "ssd_bwd": 0}


def _note(name: str, t: torch.Tensor) -> None:
    if t.is_cuda:
        CUDA_CALLS[name] += 1


def _expand_var(var: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """spher (…, K) → diag (…, K, d); diag passes through."""
    var = var.float()
    if var.dim() == mu.dim() - 1:
        var = var[..., None]
    return var.expand(mu.shape)


def _estep(x, mu, var, pi):
    x = x.float()
    mu = mu.float()
    var = _expand_var(var, mu)
    d = x.shape[-1]
    inv = 1.0 / var
    maha = (torch.einsum("...nd,...kd->...nk", x.square(), inv)
            - 2.0 * torch.einsum("...nd,...kd->...nk", x, mu * inv)
            + (mu.square() * inv).sum(-1)[..., None, :])
    logdet = var.log().sum(-1)
    logp = -0.5 * (d * _LOG2PI + logdet[..., None, :] + maha)
    logpi = pi.float().clamp_min(1e-20).log()
    return logp + logpi[..., None, :]


def estep_ref(x: torch.Tensor, mu: torch.Tensor, var: torch.Tensor,
              pi: torch.Tensor) -> torch.Tensor:
    """Diag/spher E-step log-responsibility numerators.

    x: (…, N, d); mu: (…, K, d); var: diag (…, K, d) or spher (…, K);
    pi: (…, K).  Returns log[π_k N(x_n | μ_k, Σ_k)]: (…, N, K) f32.
    """
    _note("estep", x)
    return _estep(x, mu, var, pi)


def estep_fused_ref(x: torch.Tensor, mu: torch.Tensor, var: torch.Tensor,
                    pi: torch.Tensor):
    """(log-numerators, their row logsumexp) — the fused kernel's contract.

    Accepts shared-x batching, x (Bx, N, d) against mu (B, K, d) with
    B % Bx == 0, as well as plain 2D inputs.  Shared-x batches fold the
    r = B // Bx fits of one feature block into one (N, d)·(d, r·K)
    product instead of expanding x to (B, N, d).
    """
    _note("estep_fused", x)
    if mu.dim() == 3 and x.dim() == 2:
        x = x[None]
    if mu.dim() == 3 and x.shape[0] != mu.shape[0]:
        B, K, d = mu.shape
        Bx, N = x.shape[0], x.shape[1]
        if B % Bx:
            raise ValueError(f"batch {B} must be a multiple of the {Bx} "
                             "shared feature blocks")
        r = B // Bx
        var = _expand_var(var, mu)

        def fold(a):
            return a.reshape((Bx, r * K) + tuple(a.shape[2:]))
        logp = _estep(x, fold(mu), fold(var), fold(pi))        # (Bx,N,r·K)
        logp = logp.reshape(Bx, N, r, K).permute(0, 2, 1, 3) \
            .reshape(B, N, K)
    else:
        logp = _estep(x, mu, var, pi)
    return logp, torch.logsumexp(logp, dim=-1)


def attention_mask(Sq: int, Sk: int, *, causal: bool = True,
                   window: int = 0, prefix: int = 0,
                   device=None) -> torch.Tensor:
    """(Sq, Sk) bool: which keys each query of ``attention_ref`` sees."""
    q_pos = torch.arange(Sq, device=device) + (Sk - Sq)
    k_pos = torch.arange(Sk, device=device)
    rel = q_pos[:, None] - k_pos[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= rel >= 0
    if window > 0:
        mask &= rel < window
    if prefix > 0:
        mask |= (k_pos < prefix)[None, :]
    return mask


def visible_pairs(Sq: int, Sk: int, *, causal: bool = True,
                  window: int = 0, prefix: int = 0) -> int:
    """``attention_mask(Sq, Sk, …).sum()`` without the (Sq, Sk) mask: each
    query sees the key range [lo, hi] and the first ``prefix`` keys."""
    p = torch.arange(Sq, dtype=torch.int64) + (Sk - Sq)
    hi = p.clamp(max=Sk - 1) if causal else torch.full_like(p, Sk - 1)
    lo = (p - window + 1).clamp(min=0) if window > 0 else 0 * p
    n = (hi - lo + 1).clamp(min=0)
    if prefix > 0:
        pre = min(prefix, Sk)
        outside = lo.clamp(max=pre) + (pre - hi - 1).clamp(min=0)
        n = torch.where(n > 0, n + outside, pre)
    return int(n.sum())


def _scores(q, k, causal, window, prefix):
    """(scaled f32 scores (B, Hkv, G, Sq, Sk), the (Sq, Sk) mask)."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, Hkv, H // Hkv, Sq, D)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float()) / math.sqrt(D)
    return s, attention_mask(Sq, Sk, causal=causal, window=window,
                             prefix=prefix, device=q.device)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  prefix: int = 0) -> torch.Tensor:
    """Multi-head attention: q (B, H, Sq, D); k, v (B, Hkv, Sk, D).

    Query n attends key m iff (not causal) or m ≤ n, with the queries at
    the LAST Sq positions of the Sk context; window > 0 also requires
    n − m < window; prefix > 0 makes the first ``prefix`` keys visible to
    every query.  GQA maps q head h to kv head h // (H // Hkv).
    """
    _note("attention", q)
    s, mask = _scores(q, k, causal, window, prefix)
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(q.shape).to(q.dtype)


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      prefix: int = 0) -> torch.Tensor:
    """(B, H, Sq) f32: each row's logsumexp of its visible scaled scores
    (the flash forward's second output), −inf for a row with no visible
    key."""
    _note("attention_lse", q)
    s, mask = _scores(q, k, causal, window, prefix)
    lse = torch.logsumexp(torch.where(mask, s, -math.inf), dim=-1)
    return lse.reshape(q.shape[:3])


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                      *, causal: bool = True, window: int = 0,
                      prefix: int = 0):
    """(dq, dk, dv) of ``attention_ref`` at output gradient ``do``, by the
    FlashAttention-2 formulas the backward kernel computes, in f32:

        P = exp(S·scale − lse) on visible pairs (0 elsewhere, and on rows
            whose lse is −inf),   D_i = Σ_c dO·O,
        dV = Pᵀ dO,   dS = P ∘ (dO Vᵀ − D_i),
        dQ = dS K · scale,   dK = dSᵀ Q · scale,

    with dK and dV summed over each kv head's group of query heads; each
    returned in its input's dtype.  ``o`` and ``lse`` are the forward's
    (``attention_ref`` / ``attention_lse_ref``, or the kernel's).
    """
    _note("attention_bwd", q)
    B, H, Sq, D = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    s, mask = _scores(q, k, causal, window, prefix)
    lse5 = lse.float().reshape(B, Hkv, G, Sq, 1)
    ok = mask & torch.isfinite(lse5)
    p = torch.where(ok, torch.exp(s - torch.where(ok, lse5, 0.0)), 0.0)
    do5 = do.float().reshape(B, Hkv, G, Sq, D)
    di = (do5 * o.float().reshape(B, Hkv, G, Sq, D)).sum(-1, keepdim=True)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, do5)
    ds = p * (torch.einsum("bhgqd,bhkd->bhgqk", do5, v.float()) - di)
    scale = 1.0 / math.sqrt(D)
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, k.float()) * scale
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds,
                      q.float().reshape(B, Hkv, G, Sq, D)) * scale
    return (dq.reshape(B, H, Sq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def positions_mask(q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                   causal: bool = True, window: int = 0) -> torch.Tensor:
    """(B, Sq, Sk) bool: which key slots each query of
    ``attention_positions_ref`` sees.  ``kv_pos < 0`` marks an empty
    slot; ``rel = q_pos − kv_pos`` must be ≥ 0 if causal and < window
    if window > 0."""
    rel = q_pos[:, :, None].long() - kv_pos[:, None, :].long()
    mask = (kv_pos >= 0)[:, None, :].expand(rel.shape).clone()
    if causal:
        mask &= rel >= 0
    if window > 0:
        mask &= rel < window
    return mask


def attention_positions_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, q_pos: torch.Tensor,
                            kv_pos: torch.Tensor, *, causal: bool = True,
                            window: int = 0) -> torch.Tensor:
    """Attention over a KV cache with per-row positions (the reference's
    ``layers._sdpa_chunked`` with ``kv_positions`` / ``kv_valid``).

    q: (B, H, Sq, D); k, v: (B, Hkv, Sk, D); q_pos: (B, Sq) and kv_pos:
    (B, Sk) int32 absolute positions, ``kv_pos < 0`` for an empty slot.
    Scores in f32, masked pairs at −1e30, f32 softmax; GQA maps q head h
    to kv head h // (H // Hkv).  A row with no visible key gets the mean
    of v here (the −1e30 fill), 0 from the kernel.
    """
    _note("attention_cached", q)
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = H // Hkv
    qf = q.float().reshape(B, Hkv, G, Sq, D)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float()) \
        * (1.0 / math.sqrt(D))
    mask = positions_mask(q_pos, kv_pos, causal=causal, window=window)
    s = torch.where(mask[:, None, None], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(q.shape).to(q.dtype)


def rms_norm_ref(x: torch.Tensor, gamma: torch.Tensor,
                 z: Optional[torch.Tensor] = None, eps: float = 1e-6
                 ) -> torch.Tensor:
    """RMS norm over the last dim: (x · rsqrt(mean(x²) + eps)) · gamma in
    f32, cast to x's dtype; with the gate ``z`` (Mamba2's gated norm) that
    times silu(z), each in x's dtype.  Not counted in ``CUDA_CALLS``:
    training takes it on the card by design (``models.layers.rms_norm``
    counts its rows under ``model.rms_norm.plain_rows``)."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    y = (x * torch.rsqrt(var + eps) * gamma.float()).to(dt)
    return y if z is None else y * F.silu(z)


def _chunk_len(T: int, chunk: int) -> int:
    """The reference's chunk rule: ``min(chunk, T)``, or T when that does
    not divide T."""
    C = min(chunk, T)
    return T if T % C else C


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             lw: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
             chunk: int = 16):
    """Chunked WKV6 (port of ``repro/models/rwkv.py::wkv6_chunked``).

    r, k, v, lw: (B, H, T, Dh), lw ≤ 0; u: (H, Dh); s0: (B, H, Dh, Dh).
    ``out_t = r_tᵀ(S_{t−1} + diag(u) k_t v_tᵀ)``,
    ``S_t = diag(e^{lw_t}) S_{t−1} + k_t v_tᵀ``.  Within a chunk every
    pairwise decay is an exponent ≤ 0.  Returns (out in r's dtype,
    final state f32).
    """
    _note("wkv6", r)
    B, H, T, Dh = r.shape
    C = _chunk_len(T, chunk)
    uf = u.float()
    tri = torch.tril(torch.ones((C, C), dtype=torch.bool, device=r.device),
                     diagonal=-1)                               # s < t
    S = s0.float()
    outs = []
    for c0 in range(0, T, C):
        rc, kc, vc, lwc = (a[:, :, c0:c0 + C].float() for a in (r, k, v, lw))
        cw = torch.cumsum(lwc, dim=2)                           # Σ_{j≤t} lw
        cw_prev = cw - lwc
        expo = cw_prev[:, :, :, None, :] - cw[:, :, None, :, :]  # (B,H,C,C,Dh)
        P = torch.where(tri[None, None, :, :, None], torch.exp(expo),
                        torch.zeros((), device=r.device))
        A = torch.einsum("bhtd,bhsd,bhtsd->bhts", rc, kc, P)
        diag = torch.einsum("bhtd,bhtd,hd->bht", rc, kc, uf)
        out = torch.einsum("bhts,bhse->bhte", A, vc) + diag[..., None] * vc
        out = out + torch.einsum("bhtd,bhde->bhte", rc * torch.exp(cw_prev),
                                 S)
        last = cw[:, :, -1:, :]
        kdec = kc * torch.exp(last - cw)
        S = torch.exp(last[:, :, 0, :])[..., None] * S \
            + torch.einsum("bhsd,bhse->bhde", kdec, vc)
        outs.append(out)
    return torch.cat(outs, dim=2).to(r.dtype), S


def ssd_ref(x: torch.Tensor, a_log: torch.Tensor, B: torch.Tensor,
            C: torch.Tensor, s0: torch.Tensor, chunk: int = 64):
    """Chunked Mamba2 SSD (port of ``repro/models/mamba2.py::ssd_chunked``).

    x: (Bt, H, T, P); a_log: (Bt, H, T) log decay ≤ 0; B, C: (Bt, T, N)
    shared over heads; s0: (Bt, H, N, P).  ``S_t = e^{a_t} S_{t−1} +
    B_t x_tᵀ``, ``y_t = C_tᵀ S_t``.  Returns (y in x's dtype, final state
    f32).
    """
    _note("ssd", x)
    Bt, H, T, P = x.shape
    Cn = _chunk_len(T, chunk)
    tri = torch.tril(torch.ones((Cn, Cn), dtype=torch.bool,
                                device=x.device))               # s ≤ t
    S = s0.float()
    ys = []
    for c0 in range(0, T, Cn):
        xc = x[:, :, c0:c0 + Cn].float()
        alc = a_log[:, :, c0:c0 + Cn].float()
        Bc = B[:, c0:c0 + Cn].float()
        Cc = C[:, c0:c0 + Cn].float()
        cw = torch.cumsum(alc, dim=-1)                          # Σ_{j≤t} a
        expo = cw[..., :, None] - cw[..., None, :]              # (Bt,H,C,C)
        G = torch.where(tri[None, None], torch.exp(expo),
                        torch.zeros((), device=x.device))
        CB = torch.einsum("btn,bsn->bts", Cc, Bc)
        y = torch.einsum("bhts,bhsp->bhtp", G * CB[:, None], xc)
        Cdec = Cc[:, None] * torch.exp(cw)[..., None]           # (Bt,H,C,N)
        y = y + torch.einsum("bhtn,bhnp->bhtp", Cdec, S)
        last = cw[..., -1:]                                     # (Bt,H,1)
        Bdec = Bc[:, None] * torch.exp(last[..., None] - cw[..., None])
        S = torch.exp(last)[..., None] * S \
            + torch.einsum("bhsn,bhsp->bhnp", Bdec, xc)
        ys.append(y)
    return torch.cat(ys, dim=2).to(x.dtype), S


def _sweep_dtype(t: torch.Tensor) -> torch.dtype:
    """The backward sweeps run in f32, or in float64 for float64 inputs
    (the exact answer of the checks)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def wkv6_bwd_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lw: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
                 d_out: torch.Tensor, dS_T=None):
    """(dr, dk, dv, dlw, du, dS0) of ``wkv6_ref``'s (out, final state) at
    output gradient ``d_out`` and final-state gradient ``dS_T`` (None:
    zero), by the two sweeps the backward kernel runs, in f32:

        forward:  dr_t = S_{t−1} do_t + u ⊙ k_t (v_t·do_t)
        reverse:  Ḡ_{T−1} = dS_T,   Ḡ_{t−1} = diag(e^{lw_t}) Ḡ_t + r_t do_tᵀ
                  dk_t = Ḡ_t v_t + u ⊙ r_t (v_t·do_t)
                  dv_t = Ḡ_tᵀ k_t + (r_t·(u ⊙ k_t)) do_t
                  dlw_t = e^{lw_t} ⊙ rowsum(Ḡ_t ⊙ S_{t−1})
                  du = Σ_{b,t} r_t ⊙ k_t (v_t·do_t),   dS0 = Ḡ_{−1}

    (Ḡ_t is the gradient of S_t; every decay factor is ≤ 1.)  dlw is the
    direct formula here; the kernel takes it from a prefix sum
    (``wkv6_dlw_prefix``).  dr, dk, dv in r's dtype, the rest f32 (float64
    for float64 inputs).  Keeps every S_{t−1}: B·H·T·Dh² values.
    """
    _note("wkv6_bwd", r)
    ct = _sweep_dtype(r)
    B, H, T, Dh = r.shape
    rf, kf, vf, lwf, do = (a.to(ct) for a in (r, k, v, lw, d_out))
    uf = u.to(ct)
    w = torch.exp(lwf)
    vdo = (vf * do).sum(-1)                                     # (B,H,T)
    S = s0.to(ct)
    prev, dr = [], []
    for t in range(T):
        prev.append(S)
        dr.append(torch.einsum("bhde,bhe->bhd", S, do[:, :, t]))
        S = w[:, :, t, :, None] * S \
            + kf[:, :, t, :, None] * vf[:, :, t, None, :]
    G = torch.zeros_like(S) if dS_T is None else dS_T.to(ct).clone()
    dk, dv, dlw = [None] * T, [None] * T, [None] * T
    ruk = (rf * uf[None, :, None] * kf).sum(-1)                 # (B,H,T)
    for t in range(T - 1, -1, -1):
        dk[t] = torch.einsum("bhde,bhe->bhd", G, vf[:, :, t])
        dv[t] = torch.einsum("bhde,bhd->bhe", G, kf[:, :, t]) \
            + ruk[:, :, t, None] * do[:, :, t]
        dlw[t] = w[:, :, t] * (G * prev[t]).sum(-1)
        G = w[:, :, t, :, None] * G \
            + rf[:, :, t, :, None] * do[:, :, t, None, :]
    bonus = uf[None, :, None] * vdo[..., None]                  # (B,H,T,Dh)
    dr = torch.stack(dr, 2) + bonus * kf
    dk = torch.stack(dk, 2) + bonus * rf
    du = (rf * kf * vdo[..., None]).sum((0, 2))
    return (dr.to(r.dtype), dk.to(k.dtype), torch.stack(dv, 2).to(v.dtype),
            torch.stack(dlw, 2), du, G)


def wkv6_dlw_prefix(r, k, s0, dr_tilde, dk_tilde, dS0):
    """dlw by the prefix sum the backward kernel uses, from dr and dk
    without their u terms (``dr_tilde = S_{t−1} do_t``, ``dk_tilde = Ḡ_t
    v_t``) and dS0:

        dlw_j = Σ_{s<j} k_s ⊙ dk̃_s − Σ_{t≤j} r_t ⊙ dr̃_t + rowsum(s0 ⊙ dS0)

    (from ⟨Ḡ_{t−1}, S_{t−1}⟩ = r_t·dr̃_t + dlw_t and ⟨Ḡ_t, S_t⟩ = dlw_t +
    k_t·dk̃_t, per row of the state).  No S_{t−1} and Ḡ_t of the same step
    meet, so each sweep carries one state."""
    kdk = k * dk_tilde
    rdr = r * dr_tilde
    c = (s0 * dS0).sum(-1)[:, :, None]                          # (B,H,1,Dh)
    return c + torch.cumsum(kdk, 2) - kdk - torch.cumsum(rdr, 2)


def ssd_bwd_ref(x: torch.Tensor, a_log: torch.Tensor, B: torch.Tensor,
                C: torch.Tensor, s0: torch.Tensor, dy: torch.Tensor,
                dS_T=None):
    """(dx, da_log, dB, dC, dS0) of ``ssd_ref``'s (y, final state) at
    output gradient ``dy`` and final-state gradient ``dS_T`` (None: zero),
    by the two sweeps the backward kernel runs, in f32:

        forward:  dC_t = Σ_h S_t dy_t            (S_t after step t)
        reverse:  Ḡ_{T−1} = dS_T + C_{T−1} dy_{T−1}ᵀ,
                  Ḡ_t = e^{a_{t+1}} Ḡ_{t+1} + C_t dy_tᵀ
                  dx_t = Ḡ_tᵀ B_t,   dB_t = Σ_h Ḡ_t x_t
                  da_t = e^{a_t} ⟨Ḡ_t, S_{t−1}⟩,   dS0 = e^{a_0} Ḡ_0

    B and C are shared by the heads, so dB and dC sum over them.  da is the
    direct formula here; the kernel takes it from a prefix sum
    (``ssd_da_prefix``).  dx, dB, dC in x's dtype, the rest f32 (float64
    for float64 inputs).  Keeps every S_t: Bt·H·T·N·P values.
    """
    _note("ssd_bwd", x)
    ct = _sweep_dtype(x)
    Bt, H, T, P = x.shape
    xf, dyf = x.to(ct), dy.to(ct)
    al, Bf, Cf = a_log.to(ct), B.to(ct), C.to(ct)
    ea = torch.exp(al)                                           # (Bt,H,T)
    S = s0.to(ct)
    states, dC = [S], []
    for t in range(T):
        S = ea[:, :, t, None, None] * S \
            + Bf[:, None, t, :, None] * xf[:, :, t, None, :]
        states.append(S)
        dC.append(torch.einsum("bhnp,bhp->bn", S, dyf[:, :, t]))
    G = torch.zeros_like(S) if dS_T is None else dS_T.to(ct).clone()
    dx, dB, da = [None] * T, [None] * T, [None] * T
    for t in range(T - 1, -1, -1):
        G = G + Cf[:, None, t, :, None] * dyf[:, :, t, None, :]
        dx[t] = torch.einsum("bhnp,bn->bhp", G, Bf[:, t])
        dB[t] = torch.einsum("bhnp,bhp->bn", G, xf[:, :, t])
        da[t] = ea[:, :, t] * (G * states[t]).sum((-2, -1))
        G = ea[:, :, t, None, None] * G
    return (torch.stack(dx, 2).to(x.dtype), torch.stack(da, 2),
            torch.stack(dB, 1).to(B.dtype), torch.stack(dC, 1).to(C.dtype),
            G)


def ssd_da_prefix(x, C, s0, dx, dC_heads, dS0):
    """da_log by the prefix sum the backward kernel uses, per (b, h), from
    dx, each head's own part of dC (``dC_heads`` (Bt, H, T, N), before the
    sum over heads) and dS0:

        da_j = Σ_{s<j} x_s·dx_s − Σ_{t<j} C_t·dC_t^{(h)} + ⟨s0, dS0⟩

    (from ⟨Ḡ_t, S_t⟩ = da_t + x_t·dx_t and ⟨Ḡ_{t−1}, S_{t−1}⟩ =
    C_{t−1}·dC_{t−1}^{(h)} + da_t)."""
    xdx = (x * dx).sum(-1)                                     # (Bt,H,T)
    cdc = (C[:, None] * dC_heads).sum(-1)                      # (Bt,H,T)
    c = (s0 * dS0).sum((-2, -1))[..., None]
    return c + torch.cumsum(xdx - cdc, 2) - (xdx - cdc)
