"""Gaussian mixture models in PyTorch (port of ``repro/core/gmm.py``).

Fixed-iteration weighted EM over a stack of B fits at once (the paper's
Algorithm 1, line 8, batched over clients × classes).  The diag/spher
E-step of all B fits is one ``kernels.ops.gmm_estep_fused`` call per EM
iteration — the hand-written CUDA kernel on the card, the plain version
on the CPU.  Init and M-step are batched torch ops (the reference leaves
them to XLA too).

Covariance families: ``full`` | ``diag`` | ``spher``.  ``full`` has no
kernel, in the reference as here (DESIGN §8): its E-step is a batched
Cholesky and triangular solve, its M-step K batched products, its
sampling factor a batched ``eigh`` — ``torch.linalg`` on the whole stack.

    gmm = {"pi": (…, K), "mu": (…, K, d), "cov": (…, K, d, d) | (…, K, d)
           | (…, K)}

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

from repro_torch import obs, resolve_device
from repro_torch.kernels import ops

COV_TYPES = ("full", "diag", "spher")
_LOG2PI = math.log(2.0 * math.pi)

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


def _one_hot(labels: torch.Tensor, n_classes: int) -> torch.Tensor:
    """f32 one-hot where label −1 (padding rows) maps to all zeros, as
    ``jax.nn.one_hot`` does; ``torch.nn.functional.one_hot`` raises."""
    classes = torch.arange(n_classes, device=labels.device)
    return (labels[..., None] == classes).float()


# ---------------------------------------------------------------------------
# log-density
# ---------------------------------------------------------------------------


def _cholesky(cov: torch.Tensor) -> torch.Tensor:
    """Batched lower Cholesky factor.  Where a matrix is not positive
    definite the factor is NaN, as ``jnp.linalg.cholesky`` returns it;
    ``torch.linalg.cholesky`` would raise instead."""
    chol, info = torch.linalg.cholesky_ex(cov)
    return torch.where((info != 0)[..., None, None],
                       torch.full_like(chol, float("nan")), chol)


def _full_log_prob(x: torch.Tensor, mu: torch.Tensor,
                   cov: torch.Tensor) -> torch.Tensor:
    """log N(x | mu_k, Σ_k) for full Σ over any leading batch:
    x (…, N, d), mu (…, K, d), cov (…, K, d, d) → (…, N, K)."""
    d = x.shape[-1]
    chol = _cholesky(cov)                                     # (…, K, d, d)
    diff = x.unsqueeze(-3) - mu.unsqueeze(-2)                 # (…, K, N, d)
    sol = torch.linalg.solve_triangular(chol, diff.transpose(-1, -2),
                                        upper=False)          # (…, K, d, N)
    maha = sol.square().sum(-2).transpose(-1, -2)             # (…, N, K)
    logdet = 2.0 * chol.diagonal(dim1=-2, dim2=-1).log().sum(-1)
    return -0.5 * (d * _LOG2PI + logdet.unsqueeze(-2) + maha)


def log_prob_components(x: torch.Tensor, gmm: Dict,
                        cov_type: str) -> torch.Tensor:
    """log N(x_n | mu_k, Sigma_k): (N, d) → (N, K), f32."""
    x = x.float()
    mu = gmm["mu"].float()
    cov = gmm["cov"].float()
    d = x.shape[-1]
    if cov_type == "full":
        return _full_log_prob(x, mu, cov)
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


def _log_pi(pi: torch.Tensor) -> torch.Tensor:
    return pi.float().clamp_min(1e-20).log()


def log_prob(x: torch.Tensor, gmm: Dict, cov_type: str) -> torch.Tensor:
    """Mixture log-density (N, d) → (N,).  diag/spher: the row logsumexp
    of the E-step numerators, which ``ops.gmm_estep`` (the single-fit
    kernel on the card) computes with log π folded in; full: Cholesky."""
    if cov_type == "full":
        comp = log_prob_components(x, gmm, cov_type)
        return torch.logsumexp(comp + _log_pi(gmm["pi"])[None], dim=-1)
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
    if cfg.cov_type == "full":
        return torch.diag_embed(var)[:, None].expand(B, K, d, d).contiguous()
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
    if cfg.cov_type == "full":
        # Σ_k = E[xxᵀ] − μμᵀ: K batched products (resp_k ⊙ x)ᵀ·x on the
        # shared blocks, never an (N, K, d, d) intermediate
        Bx = x.shape[0]
        xx = torch.stack([
            torch.matmul((_group(resp[..., k], Bx)[..., None]
                          * x[:, None]).transpose(-1, -2), x[:, None])
            .reshape(resp.shape[0], d, d) for k in range(resp.shape[-1])],
            dim=1)                                            # (B, K, d, d)
        cov = xx / nk_safe[..., None] - mu[..., :, None] * mu[..., None, :]
        cov = cov + cfg.reg * torch.eye(d, device=x.device)
    elif cfg.cov_type == "diag":
        cov = _wsum_rows(resp, xsq) / nk_safe - mu.square() + cfg.reg
    else:
        rowsq = _group(resp, x.shape[0]) \
            * xsq.sum(-1)[:, None, :, None]                   # (Bx,r,N,K)
        x2 = rowsq.sum(2).reshape(resp.shape[0], -1) / nk_safe[..., 0]
        cov = ((x2 - mu.square().sum(-1)) / d + cfg.reg).clamp_min(cfg.reg)
    return {"pi": pi, "mu": mu, "cov": cov}


def _estep_lr(x, gmm, cov_type: str):
    """Log-numerators lr (B, N, K) + row logsumexp (B, N) on the compact
    shared-x block x (Bx, N, d).  diag/spher: one fused E-step kernel for
    every fit.  full: the batched Cholesky path, each fit against its own
    block (broadcast, not copied)."""
    if cov_type == "full":
        Bx = x.shape[0]
        comp = _full_log_prob(x[:, None], _group(gmm["mu"], Bx),
                              _group(gmm["cov"], Bx))         # (Bx,r,N,K)
        lr = comp.reshape((-1,) + tuple(comp.shape[2:])) \
            + _log_pi(gmm["pi"])[:, None, :]
        return lr, torch.logsumexp(lr, dim=-1)
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
    with obs.span("fl.client.em", device=x):
        for _ in range(cfg.n_iter):
            lr, norm = _estep_lr(x, gmm, cfg.cov_type)
            resp = torch.exp(lr - norm[..., None]) * weights[..., None]
            gmm = _m_step(x, xsq, resp, cfg)
        # the fused E-step's logsumexp IS the mixture log-density: the
        # final log-likelihood under the returned parameters needs no
        # extra pass
        _, norm = _estep_lr(x, gmm, cfg.cov_type)
    obs.count("fl.client.em_iters", cfg.n_iter)
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
    """F with F·Fᵀ = Proj_PSD(Σ).  full: the clamped ``eigh`` factor
    U·√λ₊ over the whole (…, K, d, d) stack — it samples N(0, Proj_PSD(Σ))
    exactly and never NaNs where wire rounding or DP noise left Σ slightly
    non-PSD; diag/spher clamp at 0 and take √."""
    cf = cov.float()
    if cov_type == "full":
        evals, evecs = torch.linalg.eigh(cf)
        return evecs.mul_(evals.clamp_min(0.0).sqrt()[..., None, :]) \
            .contiguous()
    return cf.clamp_min(0.0).sqrt()


def colored_noise(fac: torch.Tensor, eps: torch.Tensor,
                  cov_type: str) -> torch.Tensor:
    """Standard-normal eps (…, d) → draw with covariance fac·facᵀ, ``fac``
    already gathered to eps's batch: full (…, d, d), diag (…, d), spher
    (…,).  For full covariance at scale use :func:`factor_noise`, which
    never gathers a d × d factor per draw."""
    if cov_type == "full":
        return torch.einsum("...de,...e->...d", fac, eps)
    if cov_type == "diag":
        return fac * eps
    return fac[..., None] * eps


def _grouped_full_noise(fac: torch.Tensor, ids: torch.Tensor,
                        eps: torch.Tensor) -> torch.Tensor:
    """F[ids]·eps for full factors, grouped by id: the draws of each id
    used are gathered into one padded block and multiplied by that id's
    Fᵀ in one batched product, then scattered back.  The same draws give
    the gathered form's numbers up to summation order, and the memory is
    O(ids used · d² + draws · d), not O(draws · d²)."""
    shape = eps.shape
    d = shape[-1]
    ids = ids.reshape(-1)
    eps = eps.reshape(-1, d).float()
    n = ids.shape[0]
    if n == 0:
        return eps.reshape(shape)
    uniq, inv, cnt = torch.unique(ids, sorted=True, return_inverse=True,
                                  return_counts=True)
    order = torch.argsort(inv, stable=True)
    grp = inv[order]
    rank = torch.arange(n, device=eps.device) - (torch.cumsum(cnt, 0)
                                                 - cnt)[grp]
    # full covariance is never captured (launch/aot_cache.py runs it eagerly)
    block = eps.new_zeros((uniq.shape[0], int(cnt.max()), d))  # lint: disable=HOST-SYNC
    block[grp, rank] = eps[order]
    f = fac if uniq.shape[0] == fac.shape[0] else fac.index_select(0, uniq)
    prod = torch.bmm(block, f.transpose(1, 2))                # rows (F·ε)ᵀ
    out = torch.empty_like(eps)
    out[order] = prod[grp, rank]
    return out.reshape(shape)


def factor_noise(fac: torch.Tensor, ids: torch.Tensor, eps: torch.Tensor,
                 cov_type: str) -> torch.Tensor:
    """``F[ids]·eps`` for a flat (P, …) factor stack, ids of any shape and
    eps (ids.shape, d).  diag/spher gather; full groups the draws by id
    (:func:`_grouped_full_noise`) instead of gathering a d × d factor per
    draw — at d = 1280 the gathered form of one (32, 256) noise window
    would be 53.7 GB."""
    if cov_type == "full":
        return _grouped_full_noise(fac, ids, eps)
    return colored_noise(fac[ids], eps, cov_type)


def draw_slots(u: torch.Tensor, cum_mass: torch.Tensor) -> torch.Tensor:
    """Slot ids for uniforms ``u`` (n,) via the cumulative-mass table:
    binary search (``side="right"``) clipped to the last slot."""
    idx = torch.searchsorted(cum_mass, u, right=True)
    return idx.clamp(0, cum_mass.shape[0] - 1)


def slot_gaussian(slot, comp, eps, mu, fac, cov_type: str) -> torch.Tensor:
    """``mu[slot, comp] + F[slot, comp]·eps`` for any leading batch shape;
    ``fac`` (G, K, …) is :func:`sampling_factor` output."""
    K = mu.shape[1]
    flat = fac.reshape((-1,) + tuple(fac.shape[2:]))
    return mu[slot, comp].float() + factor_noise(flat, slot * K + comp, eps,
                                                 cov_type)


def sample_slot_minibatch(cum_mass, pi, mu, fac, slot_labels, n: int,
                          cov_type: str, *,
                          generator: Optional[torch.Generator] = None,
                          draws: Optional[Dict[str, torch.Tensor]] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One synthetic minibatch straight from a flat (G, K, …) slot stack:
    slot ∝ counts via ``cum_mass``, component ∝ pi, Gaussian through the
    precomputed ``fac``.  ``draws`` replaces the draws: ``u`` (n,)
    uniforms, ``comp`` (n,), ``eps`` (n, d).  Returns (x (n, d), y (n,))."""
    dev = mu.device
    if draws is None:
        slot = draw_slots(torch.rand((n,), generator=generator, device=dev),
                          cum_mass)
        comp = torch.multinomial(pi.float().clamp_min(1e-20)[slot], 1,
                                 generator=generator)[:, 0]
        eps = torch.randn((n, mu.shape[-1]), generator=generator,
                          device=dev, dtype=torch.float32)
    else:
        slot = draw_slots(draws["u"].to(dev), cum_mass)
        comp = draws["comp"].to(dev).long()
        eps = draws["eps"].to(dev, torch.float32)
    return (slot_gaussian(slot, comp, eps, mu, fac, cov_type),
            slot_labels[slot])


def identity_gmm(K: int, d: int, cov_type: str) -> Dict[str, np.ndarray]:
    """Inert padding mixture: uniform pi, zero means, unit covariance —
    safe under every sampler primitive.  Pad rows carry draw count 0, so
    the fused head never selects them (DESIGN §11)."""
    if cov_type == "full":
        cov = np.tile(np.eye(d, dtype=np.float32)[None], (K, 1, 1))
    elif cov_type == "diag":
        cov = np.ones((K, d), np.float32)
    elif cov_type == "spher":
        cov = np.ones((K,), np.float32)
    else:
        raise ValueError(f"identity_gmm: unknown cov_type {cov_type!r} — "
                         f"choose one of {COV_TYPES}")
    return {"pi": np.full((K,), 1.0 / K, np.float32),
            "mu": np.zeros((K, d), np.float32), "cov": cov}


def sample(gmm: Dict, n: int, cov_type: str, *,
           generator: Optional[torch.Generator] = None,
           comp: Optional[torch.Tensor] = None,
           eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """n draws from one mixture → (n, d); runs where ``gmm["mu"]`` lies.
    ``comp`` (n,) and ``eps`` (n, d) replace the draws."""
    mu = torch.as_tensor(gmm["mu"]).float()
    dev = mu.device
    if comp is None:
        pi = torch.as_tensor(gmm["pi"]).float().clamp_min(1e-20)
        comp = torch.multinomial(pi, n, replacement=True,
                                 generator=generator)
    if eps is None:
        eps = torch.randn((n, mu.shape[-1]), generator=generator,
                          device=dev, dtype=torch.float32)
    comp = comp.to(dev).long()
    fac = sampling_factor(torch.as_tensor(gmm["cov"]).to(dev), cov_type)
    return mu[comp] + factor_noise(fac, comp, eps.to(dev, torch.float32),
                                   cov_type)


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


def tril_pack(cov):
    """Row-major lower-triangle packing (…, d, d) → (…, d·(d+1)/2): THE
    wire layout of full covariances (``np.tril_indices`` order).  numpy in
    → numpy out, tensor in → tensor out."""
    d = cov.shape[-1]
    i, j = np.tril_indices(d)
    if isinstance(cov, np.ndarray):
        return cov[..., i, j]
    return cov[..., torch.as_tensor(i, device=cov.device),
               torch.as_tensor(j, device=cov.device)]


def tril_unpack(packed, d: int):
    """Inverse of :func:`tril_pack`: the symmetric (…, d, d) f32 matrix
    from its row-major lower triangle.  numpy in → numpy out, tensor in →
    tensor out."""
    i, j = np.tril_indices(d)
    if isinstance(packed, np.ndarray):
        cov = np.zeros(packed.shape[:-1] + (d, d), np.float32)
        cov[..., i, j] = packed
        sym = cov + np.swapaxes(cov, -1, -2)
        diag = np.arange(d)
        sym[..., diag, diag] = cov[..., diag, diag]
        return sym
    ti = torch.as_tensor(i, device=packed.device)
    tj = torch.as_tensor(j, device=packed.device)
    cov = packed.new_zeros(tuple(packed.shape[:-1]) + (d, d),
                           dtype=torch.float32)
    cov[..., ti, tj] = packed.float()
    return cov + cov.transpose(-1, -2) \
        - torch.diag_embed(cov.diagonal(dim1=-2, dim2=-1))


def pack_wire(gmm: Dict, cov_type: str) -> Dict:
    """bf16 wire-format dict, full covariances tril-packed."""
    cov = gmm["cov"]
    if cov_type == "full":
        cov = tril_pack(cov)
    return {"pi": gmm["pi"].to(torch.bfloat16),
            "mu": gmm["mu"].to(torch.bfloat16),
            "cov": cov.to(torch.bfloat16)}


def unpack_wire(packed: Dict, cov_type: str, d: int) -> Dict:
    out = {"pi": packed["pi"].float(), "mu": packed["mu"].float()}
    if cov_type == "full":
        out["cov"] = tril_unpack(packed["cov"], d)
    else:
        out["cov"] = packed["cov"].float()
    return out
