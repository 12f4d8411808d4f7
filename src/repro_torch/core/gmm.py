"""Gaussian mixture models in PyTorch (port of ``repro/core/gmm.py``).

Fixed-iteration weighted EM over a stack of B fits at once (the paper's
Algorithm 1, line 8, batched over clients × classes).  The diag/spher
E-step of all B fits is one ``kernels.ops.gmm_estep_fused`` call per EM
iteration — the hand-written CUDA kernel on the card, the plain version
on the CPU.  Init and M-step are batched torch ops (the reference leaves
them to XLA too).

Covariance families: ``diag`` | ``spher``.  ``full`` waits for its slice
(ROADMAP, port queue: full-covariance EM and the ``tril_pack`` wire).

    gmm = {"pi": (…, K), "mu": (…, K, d), "cov": (…, K, d) | (…, K)}

Random draws come from an explicit ``torch.Generator``, or are passed in
as tensors (``init_idx``, ``jitter``) so tests can feed both packages the
same draws: JAX's threefry and torch's Philox cannot match stream for
stream.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import ops

COV_TYPES = ("full", "diag", "spher")
_LOG2PI = math.log(2.0 * math.pi)
_FULL_COV = ("cov_type='full' waits for its slice (ROADMAP, port queue: "
             "full-covariance EM and the tril_pack wire)")

Device = Optional[Union[str, torch.device]]


@dataclasses.dataclass(frozen=True)
class GMMConfig:
    n_components: int = 10
    cov_type: str = "diag"
    n_iter: int = 30
    kmeans_iter: int = 5
    reg: float = 1e-4

    def __post_init__(self):
        if self.cov_type not in COV_TYPES:
            raise ValueError(f"GMMConfig: unknown cov_type {self.cov_type!r}")


def _no_full(cov_type: str) -> None:
    if cov_type == "full":
        raise NotImplementedError(_FULL_COV)


def _one_hot(labels: torch.Tensor, n_classes: int) -> torch.Tensor:
    """f32 one-hot where label −1 (padding rows) maps to all zeros, as
    ``jax.nn.one_hot`` does; ``torch.nn.functional.one_hot`` raises."""
    classes = torch.arange(n_classes, device=labels.device)
    return (labels[..., None] == classes).float()


# ---------------------------------------------------------------------------
# log-density
# ---------------------------------------------------------------------------


def log_prob_components(x: torch.Tensor, gmm: Dict,
                        cov_type: str) -> torch.Tensor:
    """log N(x_n | mu_k, Sigma_k): (N, d) → (N, K), f32."""
    _no_full(cov_type)
    x = x.float()
    mu = gmm["mu"].float()
    cov = gmm["cov"].float()
    d = x.shape[-1]
    if cov_type == "diag":
        inv = 1.0 / cov
        maha = (x.square() @ inv.T - 2.0 * (x @ (mu * inv).T)
                + (mu.square() * inv).sum(-1)[None])
        logdet = cov.log().sum(-1)
    else:
        sq = x.square().sum(-1, keepdim=True)
        maha = (sq - 2.0 * (x @ mu.T) + mu.square().sum(-1)[None]) / cov[None]
        logdet = d * cov.log()
    return -0.5 * (d * _LOG2PI + logdet[None] + maha)


def log_prob(x: torch.Tensor, gmm: Dict, cov_type: str) -> torch.Tensor:
    """Mixture log-density (N, d) → (N,): the row logsumexp of the E-step
    numerators, which ``ops.gmm_estep`` (the single-fit kernel on the
    card) computes with log π folded in."""
    _no_full(cov_type)
    return torch.logsumexp(ops.gmm_estep(x, gmm["mu"], gmm["cov"],
                                         gmm["pi"]), dim=-1)


# ---------------------------------------------------------------------------
# init (weighted k-means seeding)
# ---------------------------------------------------------------------------


def kmeans_draws(weights: torch.Tensor, cfg: GMMConfig, d: int,
                 generator: torch.Generator):
    """Seed indices (B, K) ∝ weights (uniform for an all-zero row) and the
    N(0, 1) jitter (B, K, d) — what ``_kmeans_init`` draws."""
    B, N = weights.shape
    total = weights.sum(-1, keepdim=True)
    p = torch.where(total > 0, weights / total.clamp_min(1e-12),
                    torch.full_like(weights, 1.0 / N))
    idx = torch.multinomial(p, cfg.n_components, replacement=True,
                            generator=generator)
    jitter = torch.randn((B, cfg.n_components, d), generator=generator,
                         device=weights.device, dtype=torch.float32)
    return idx, jitter


def _group(a: torch.Tensor, Bx: int) -> torch.Tensor:
    """(B, …) → (Bx, r, …): fits grouped by the feature block they share."""
    return a.reshape((Bx, a.shape[0] // Bx) + tuple(a.shape[1:]))


def _wsum_rows(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Σ_n w[b, n, j]·x[b // r, n, :] → (B, J, d) as one (r·J, N)·(N, d)
    product per shared block — no expanded copy of x."""
    Bx, N, d = x.shape
    B, _, J = w.shape
    r = B // Bx
    wt = _group(w, Bx).permute(0, 1, 3, 2).reshape(Bx, r * J, N)
    return torch.bmm(wt, x).reshape(B, J, d)


def _kmeans_init(x, weights, cfg: GMMConfig, idx, jitter):
    """Weighted k-means from seeds x[idx] + 1e-3·jitter.  x (Bx, N, d)."""
    Bx, N, d = x.shape
    B, K = idx.shape
    r = B // Bx
    rows = (torch.arange(B, device=x.device) // r)[:, None]
    mu = x[rows, idx] + 1e-3 * jitter                         # (B, K, d)
    xsq = x.square().sum(-1).repeat_interleave(r, 0)          # (B, N)
    for _ in range(cfg.kmeans_iter):
        cross = torch.bmm(x, mu.reshape(Bx, r * K, d).transpose(1, 2))
        cross = cross.reshape(Bx, N, r, K).permute(0, 2, 1, 3) \
            .reshape(B, N, K)                                 # x·μᵀ per fit
        d2 = (xsq[..., None] - 2 * cross
              + mu.square().sum(-1)[:, None, :])
        assign = _one_hot(d2.argmin(-1), K) * weights[..., None]
        cnt = assign.sum(1)                                   # (B, K)
        new_mu = _wsum_rows(assign, x) / cnt.clamp_min(1e-12)[..., None]
        mu = torch.where((cnt > 1e-12)[..., None], new_mu, mu)
    return mu


def _global_cov(x, weights, cfg: GMMConfig):
    """Per-fit weighted variance + reg, tiled to every component."""
    Bx, N, d = x.shape
    B = weights.shape[0]
    wsum = weights.sum(-1).clamp_min(1e-12)                   # (B,)
    mean = _wsum_rows(weights[..., None], x)[:, 0] / wsum[:, None]
    diff = x[:, None] - _group(mean, Bx)[:, :, None]          # (Bx,r,N,d)
    var = (torch.einsum("brn,brnd->brd", _group(weights, Bx), diff.square())
           .reshape(B, d) / wsum[:, None] + cfg.reg)
    K = cfg.n_components
    if cfg.cov_type == "diag":
        return var[:, None].expand(B, K, d).contiguous()
    return var.mean(-1, keepdim=True).expand(B, K).contiguous()


# ---------------------------------------------------------------------------
# EM
# ---------------------------------------------------------------------------


def _m_step(x, xsq, resp, cfg: GMMConfig) -> Dict:
    """resp (B, N, K), already weight-multiplied; x (Bx, N, d)."""
    d = x.shape[-1]
    nk = resp.sum(1)                                          # (B, K)
    pi = nk / nk.sum(-1, keepdim=True).clamp_min(1e-12)
    nk_safe = nk.clamp_min(1e-12)[..., None]
    mu = _wsum_rows(resp, x) / nk_safe
    if cfg.cov_type == "diag":
        cov = _wsum_rows(resp, xsq) / nk_safe - mu.square() + cfg.reg
    else:
        rowsq = _group(resp, x.shape[0]) \
            * xsq.sum(-1)[:, None, :, None]                   # (Bx,r,N,K)
        x2 = rowsq.sum(2).reshape(resp.shape[0], -1) / nk_safe[..., 0]
        cov = ((x2 - mu.square().sum(-1)) / d + cfg.reg).clamp_min(cfg.reg)
    return {"pi": pi, "mu": mu, "cov": cov}


def _estep_lr(x, gmm, cov_type: str):
    """Log-numerators lr (B, N, K) + row logsumexp (B, N): one fused E-step
    for every fit, on the compact shared-x block x (Bx, N, d)."""
    _no_full(cov_type)
    return ops.gmm_estep_fused(x, gmm["mu"], gmm["cov"], gmm["pi"])


@torch.no_grad()
def fit_gmm_batch(x: torch.Tensor, weights: torch.Tensor, cfg: GMMConfig, *,
                  generator: Optional[torch.Generator] = None,
                  init_idx: Optional[torch.Tensor] = None,
                  jitter: Optional[torch.Tensor] = None
                  ) -> Tuple[Dict, torch.Tensor]:
    """Weighted EM over a stack of B fits; runs where ``x`` lies.

    weights: (B, N); x: (Bx, N, d) with B % Bx == 0 — each run of B // Bx
    consecutive fits shares one feature block.  A zero weight masks a
    row; an all-zero row (absent class) still returns finite params.
    The k-means draws come from ``generator`` unless ``init_idx`` (B, K)
    and ``jitter`` (B, K, d) are given.  Returns (gmms stacked (B, …),
    mean log-likelihoods (B,)).
    """
    _no_full(cfg.cov_type)
    if weights.dim() != 2:
        raise ValueError(f"fit_gmm_batch: weights must be (B, N), got "
                         f"{tuple(weights.shape)}")
    if x.dim() != 3:
        raise ValueError(f"fit_gmm_batch: x must be (Bx, N, d), got "
                         f"{tuple(x.shape)}")
    B, (Bx, N, d) = weights.shape[0], x.shape
    if Bx == 0 or B % Bx:
        raise ValueError(f"fit_gmm_batch: B={B} fits do not evenly share "
                         f"Bx={Bx} feature blocks")
    if weights.shape[1] != N:
        raise ValueError(f"fit_gmm_batch: weights rows ({weights.shape[1]}) "
                         f"must match x's sample axis N={N}")
    x = x.float()
    weights = weights.float().to(x.device)
    if init_idx is None or jitter is None:
        if generator is None:
            raise ValueError("fit_gmm_batch: pass a generator or the "
                             "k-means draws (init_idx, jitter)")
        init_idx, jitter = kmeans_draws(weights, cfg, d, generator)
    init_idx = init_idx.to(x.device)
    jitter = jitter.to(x.device, torch.float32)
    xsq = x.square()
    K = cfg.n_components
    gmm = {"pi": torch.full((B, K), 1.0 / K, device=x.device),
           "mu": _kmeans_init(x, weights, cfg, init_idx, jitter),
           "cov": _global_cov(x, weights, cfg)}
    wsum = weights.sum(-1).clamp_min(1e-12)
    for _ in range(cfg.n_iter):
        lr, norm = _estep_lr(x, gmm, cfg.cov_type)
        resp = torch.exp(lr - norm[..., None]) * weights[..., None]
        gmm = _m_step(x, xsq, resp, cfg)
    # the fused E-step's logsumexp IS the mixture log-density: the final
    # log-likelihood under the returned parameters needs no extra pass
    _, norm = _estep_lr(x, gmm, cfg.cov_type)
    return gmm, (norm * weights).sum(-1) / wsum


def fit_gmm(x: torch.Tensor, weights: torch.Tensor, cfg: GMMConfig, *,
            generator: Optional[torch.Generator] = None,
            init_idx: Optional[torch.Tensor] = None,
            jitter: Optional[torch.Tensor] = None
            ) -> Tuple[Dict, torch.Tensor]:
    """Weighted EM of one mixture: x (N, d), weights (N,) → (gmm, mean
    log-likelihood), the paper's ``L_EM``.  The B = 1 case of
    :func:`fit_gmm_batch`; injected draws are (K,) and (K, d)."""
    gmm, ll = fit_gmm_batch(
        x[None], weights[None], cfg, generator=generator,
        init_idx=None if init_idx is None else init_idx[None],
        jitter=None if jitter is None else jitter[None])
    return {k: v[0] for k, v in gmm.items()}, ll[0]


def fit_classwise_gmms_batched(feats: torch.Tensor, labels: torch.Tensor,
                               n_classes: int, cfg: GMMConfig, *,
                               generator: Optional[torch.Generator] = None,
                               init_idx: Optional[torch.Tensor] = None,
                               jitter: Optional[torch.Tensor] = None):
    """Per-class GMMs for a cohort in one batched EM; runs where ``feats``
    lies.  feats (M, N, d); labels (M, N) with −1 padding.  Injected
    draws are (M·C, K) and (M·C, K, d).  Returns (gmms (M, C, …),
    counts (M, C), logliks (M, C))."""
    M = feats.shape[0]
    onehot = _one_hot(labels.to(feats.device).long(), n_classes)  # (M,N,C)
    counts = onehot.sum(1)
    weights = onehot.transpose(1, 2).reshape(M * n_classes, -1)
    gmms, lls = fit_gmm_batch(feats, weights, cfg, generator=generator,
                              init_idx=init_idx, jitter=jitter)
    gmms = {k: v.reshape((M, n_classes) + tuple(v.shape[1:]))
            for k, v in gmms.items()}
    return gmms, counts, lls.reshape(M, n_classes)


def fit_classwise_gmms(feats: torch.Tensor, labels: torch.Tensor,
                       n_classes: int, cfg: GMMConfig, *,
                       device: Device = None,
                       generator: Optional[torch.Generator] = None,
                       init_idx: Optional[torch.Tensor] = None,
                       jitter: Optional[torch.Tensor] = None):
    """One GMM per class (Algorithm 1, lines 6-9).  Entry point: runs on
    ``cuda`` unless ``device="cpu"``.  Returns (gmms stacked over the class
    axis, counts (C,), logliks (C,)); absent classes get finite
    placeholder params — mask with counts."""
    dev = resolve_device(device)
    if generator is None and init_idx is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    gmms, counts, lls = fit_classwise_gmms_batched(
        torch.as_tensor(feats).to(dev)[None],
        torch.as_tensor(labels).to(dev)[None], n_classes, cfg,
        generator=generator, init_idx=init_idx, jitter=jitter)
    return {k: v[0] for k, v in gmms.items()}, counts[0], lls[0]


# ---------------------------------------------------------------------------
# sampler primitives (server side — Algorithm 1, line 14)
# ---------------------------------------------------------------------------


def sampling_factor(cov: torch.Tensor, cov_type: str) -> torch.Tensor:
    """F with F·Fᵀ = Proj_PSD(Σ): diag/spher clamp at 0 and take √."""
    _no_full(cov_type)
    return cov.float().clamp_min(0.0).sqrt()


def colored_noise(fac: torch.Tensor, eps: torch.Tensor,
                  cov_type: str) -> torch.Tensor:
    """Standard-normal eps (…, d) → draw with covariance fac·facᵀ."""
    _no_full(cov_type)
    if cov_type == "diag":
        return fac * eps
    return fac[..., None] * eps


def draw_slots(u: torch.Tensor, cum_mass: torch.Tensor) -> torch.Tensor:
    """Slot ids for uniforms ``u`` (n,) via the cumulative-mass table:
    binary search (``side="right"``) clipped to the last slot."""
    idx = torch.searchsorted(cum_mass, u, right=True)
    return idx.clamp(0, cum_mass.shape[0] - 1)


def slot_gaussian(slot, comp, eps, mu, fac, cov_type: str) -> torch.Tensor:
    """``mu[slot, comp] + F[slot, comp]·eps`` for any leading batch shape."""
    return mu[slot, comp].float() + colored_noise(fac[slot, comp], eps,
                                                  cov_type)


def identity_gmm(K: int, d: int, cov_type: str) -> Dict[str, np.ndarray]:
    """Inert padding mixture: uniform pi, zero means, unit covariance."""
    _no_full(cov_type)
    if cov_type == "diag":
        cov = np.ones((K, d), np.float32)
    elif cov_type == "spher":
        cov = np.ones((K,), np.float32)
    else:
        raise ValueError(f"identity_gmm: unknown cov_type {cov_type!r} — "
                         f"choose one of {COV_TYPES}")
    return {"pi": np.full((K,), 1.0 / K, np.float32),
            "mu": np.zeros((K, d), np.float32), "cov": cov}


# ---------------------------------------------------------------------------
# wire format / communication accounting (paper Eqs. 9-11)
# ---------------------------------------------------------------------------

WIRE_FIELDS = ("pi", "mu", "cov")


def packed_cov_shape(cov_type: str, K: int, d: int) -> Tuple[int, ...]:
    """Per-class shape of the ``cov`` wire leaf (full covs tril-packed)."""
    if cov_type == "full":
        return (K, d * (d + 1) // 2)
    if cov_type == "diag":
        return (K, d)
    return (K,)


def n_parameters(cov_type: str, d: int, K: int, C: int) -> int:
    """Scalars of one client's per-class GMM transfer, from the wire
    layout: pi (K,) + mu (K, d) + packed cov."""
    cov_scalars = int(np.prod(packed_cov_shape(cov_type, K, d),
                              dtype=np.int64))
    return (K + K * d + cov_scalars) * C


def comm_bytes(cov_type: str, d: int, K: int, C: int,
               bytes_per_scalar: int = 2) -> int:
    """Paper's 16-bit wire encoding (§5.1) → bytes on the wire."""
    return n_parameters(cov_type, d, K, C) * bytes_per_scalar


def raw_feature_bytes(n_samples: int, d: int,
                      bytes_per_scalar: int = 2) -> int:
    """Cost of the Centralized baseline: ship every feature row."""
    return n_samples * (d + 1) * bytes_per_scalar


def nonfinite_fields(params, fields: Tuple[str, ...] = WIRE_FIELDS):
    """Names of wire fields carrying NaN/Inf — ``[]`` when clean."""
    return [f for f in fields
            if not np.isfinite(np.asarray(torch.as_tensor(params[f])
                                          .detach().float().cpu())).all()]
