"""DP-FedPFT: Theorem 4.1's Gaussian mechanism over (mu, Sigma) (port of
``repro/core/dp.py``).

For K = 1 full-covariance Gaussians over features normalized to
||f||₂ ≤ 1:

    sigma  = (4 / (n·eps)) · sqrt(5·ln(4/delta))
    mu~    = mu^ + N(0, sigma²)                    elementwise
    Sigma~ = Proj_PSD(Sigma^ + N(0, sigma²))       symmetric noise

Every function is batched over leading axes (one call for all C classes,
each at its own σ ∝ 1/n_c).  The Gaussian draws come from a
``torch.Generator`` or are passed in (``draws``: ``mu_eps`` (…, d) and the
full ``raw`` (…, d, d) matrix whose upper triangle ``symmetric_noise``
keeps), so tests can feed the reference's draws.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

Draws = Optional[Dict[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class DPConfig:
    epsilon: float = 1.0
    delta: float = 1e-3      # paper sets delta = 1/|D^{i,c}| per class
    reg: float = 1e-6        # PSD floor after projection


def noise_scale(n, eps: float, delta: float):
    """Theorem 4.1's per-element Gaussian std; ``n`` a count or a tensor
    of per-class counts."""
    return (4.0 / (n * eps)) * math.sqrt(5.0 * math.log(4.0 / delta))


def symmetric_noise(d: int, sigma, *,
                    generator: Optional[torch.Generator] = None,
                    raw: Optional[torch.Tensor] = None,
                    device=None) -> torch.Tensor:
    """Symmetric (…, d, d) noise with per-element std exactly σ (a scalar
    or one per leading index): the upper triangle (diagonal included) of
    a standard-normal ``raw`` (…, d, d) at full σ, mirrored.
    ``0.5·(E + Eᵀ)`` would leave the off-diagonals at σ/√2 and weaken the
    (ε, δ) guarantee.  ``raw`` replaces the (d, d) draw."""
    if raw is None:
        raw = torch.randn((d, d), generator=generator, device=device,
                          dtype=torch.float32)
    sigma = torch.as_tensor(sigma, dtype=torch.float32, device=raw.device)
    upper = torch.triu(raw)
    return sigma[..., None, None] * (upper + torch.triu(raw, 1)
                                     .transpose(-1, -2))


def project_psd(sym: torch.Tensor, floor: float = 0.0) -> torch.Tensor:
    """Eigenvalue clamp onto the PSD cone (post-processing: DP-free),
    batched over leading axes."""
    sym = 0.5 * (sym + sym.transpose(-1, -2))
    evals, evecs = torch.linalg.eigh(sym)
    evals = evals.clamp_min(floor)
    return (evecs * evals[..., None, :]) @ evecs.transpose(-1, -2)


def _draws(mu: torch.Tensor, generator, draws: Draws):
    if draws is not None:
        return (draws["mu_eps"].to(mu.device, torch.float32),
                draws["raw"].to(mu.device, torch.float32))
    d = mu.shape[-1]
    kw = dict(generator=generator, device=mu.device, dtype=torch.float32)
    return (torch.randn(tuple(mu.shape), **kw),
            torch.randn(tuple(mu.shape) + (d,), **kw))


def _privatize_with_sigma(mu: torch.Tensor, cov: torch.Tensor, sigma,
                          reg: float, *,
                          generator: Optional[torch.Generator] = None,
                          draws: Draws = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The mechanism at a given σ (a scalar or one per leading index):
    mu (…, d), cov (…, d, d)."""
    mu, cov = mu.float(), cov.float()
    mu_eps, raw = _draws(mu, generator, draws)
    s = torch.as_tensor(sigma, dtype=torch.float32, device=mu.device)
    mu_t = mu + s[..., None] * mu_eps
    noise = symmetric_noise(mu.shape[-1], s, raw=raw)
    cov_t = project_psd(cov + noise, reg)
    return mu_t, cov_t


def privatize_gaussian(mu: torch.Tensor, cov: torch.Tensor, n: int,
                       cfg: DPConfig, *,
                       generator: Optional[torch.Generator] = None,
                       draws: Draws = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gaussian mechanism on one class's (mu^, Sigma^), n its sample
    count; the caller normalized the features to the unit ball."""
    sigma = noise_scale(max(n, 1), cfg.epsilon, cfg.delta)
    return _privatize_with_sigma(mu, cov, sigma, cfg.reg,
                                 generator=generator, draws=draws)


def privatize_classwise(gmms: Dict, counts, cfg: DPConfig, *,
                        generator: Optional[torch.Generator] = None,
                        draws: Draws = None) -> Dict:
    """The mechanism on stacked per-class K = 1 full-cov GMMs: pi (C, 1),
    mu (C, 1, d), cov (C, 1, d, d).  One batched call for all C classes,
    each at its own σ ∝ 1/n_c (empty classes are noised at n = 1 but
    never transmitted: their counts stay 0).  ``draws``: ``mu_eps``
    (C, d), ``raw`` (C, d, d)."""
    mu = torch.as_tensor(gmms["mu"])
    cov = torch.as_tensor(gmms["cov"]).to(mu.device)
    C = mu.shape[0]
    n = np.maximum(np.asarray(torch.as_tensor(counts).cpu(), np.float64)
                   .reshape(C), 1).astype(np.float32)
    sigmas = torch.from_numpy(noise_scale(n, cfg.epsilon, cfg.delta)
                              .astype(np.float32)).to(mu.device)
    mu_t, cov_t = _privatize_with_sigma(mu[:, 0], cov[:, 0], sigmas, cfg.reg,
                                        generator=generator, draws=draws)
    return {"pi": torch.as_tensor(gmms["pi"]).to(mu.device),
            "mu": mu_t[:, None], "cov": cov_t[:, None]}


def run_dp_fedpft(client_datasets, n_classes: int, fp_cfg,
                  dp_cfg: DPConfig, min_class_count: int = 0, *,
                  seed: int = 0, device=None):
    """One-shot DP-FedPFT through ``FedSession`` (Star): clients fit K = 1
    full-covariance per-class Gaussians over unit-norm features, privatize
    them with the Theorem 4.1 mechanism, and the messages go through the
    same codec and server as FedPFT.  ``min_class_count`` drops classes
    too small to survive the σ ∝ 1/n noise; if it drops every class the
    session returns the empty-cohort result.  Entry point: runs on
    ``cuda`` unless ``device="cpu"``.  Returns (head, info) with
    ``info["comm_bytes"]`` = Σ ``len(payload)``."""
    from repro_torch.core.fedpft import session_for
    if fp_cfg.gmm.n_components != 1 or fp_cfg.gmm.cov_type != "full":
        raise ValueError("Theorem 4.1 requires K=1 full-covariance "
                         "summaries")
    sess = session_for(n_classes, fp_cfg, dp=dp_cfg,
                       normalize_features=True,
                       min_class_count=min_class_count)
    res = sess.run(client_datasets, seed=seed, device=device)
    info = dict(res.info)
    info["messages"] = res.messages
    return res.model, info
