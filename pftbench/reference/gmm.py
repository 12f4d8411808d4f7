"""Plain class-wise diagonal EM of one FedPFT client, and the draws it starts
from.

The EM is Algorithm 1's client: per present class one K-component diagonal
mixture, seeded by weighted k-means from K rows drawn in proportion to the
class's weights plus 1e-3 N(0, 1) jitter, the global per-class variance plus
``reg`` as every component's starting covariance, then ``n_iter`` E/M steps
and the final mean log-likelihood.  The draws are those a FedPFT round's client
``i`` makes from its stream: ``round_generator(seed, 1 + i)``, a torch
generator seeded by splitmix64 of the round's seed mixed with the stream
index (the server's stream is 0), first the K seed rows of every class, then
the jitter.  The reference imports nothing of the program.

The cells' comparison reads the log-likelihood of given mixtures
(``mean_loglik``) and what one more EM step from them adds (``em_gain``);
the control runs ``fit_client`` in the program's place
with its E-step's log densities (the program's E-step kernel) taken with
TF32 products: the EM is configured in float32 with TF32 off.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

_SM_GAMMA = np.uint64(0x9E3779B97F4A7C15)
_SM_M1 = np.uint64(0xBF58476D1CE4E5B9)
_SM_M2 = np.uint64(0x94D049BB133111EB)
LOG2PI = math.log(2.0 * math.pi)


def splitmix64(x: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        x = x + _SM_GAMMA
        x = (x ^ (x >> np.uint64(30))) * _SM_M1
        x = (x ^ (x >> np.uint64(27))) * _SM_M2
        return x ^ (x >> np.uint64(31))


def stream_seed(seed: int, index: int) -> int:
    """The torch seed of stream ``index`` of a round seeded ``seed``."""
    x = np.asarray([seed], np.uint64)
    h = splitmix64(splitmix64(x) ^ np.uint64(index))
    return int(h[0] >> np.uint64(1))


def round_generator(seed: int, index: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, index))
    return g


def class_weights(labels: torch.Tensor, n_classes: int) -> torch.Tensor:
    """(C, N) float32 one-hot weights of each class's rows."""
    classes = torch.arange(n_classes, device=labels.device)
    return (labels.long()[None, :] == classes[:, None]).float()


def kmeans_draws(weights: torch.Tensor, K: int, d: int,
                 generator: torch.Generator):
    """(seed rows (C, K), jitter (C, K, d)): K rows per class in proportion
    to its weights (uniform for an empty class), then N(0, 1) jitter."""
    C, N = weights.shape
    total = weights.sum(-1, keepdim=True)
    p = torch.where(total > 0, weights / total.clamp_min(1e-12),
                    torch.full_like(weights, 1.0 / N))
    idx = torch.multinomial(p, K, replacement=True, generator=generator)
    jitter = torch.randn((C, K, d), generator=generator,
                         device=weights.device, dtype=torch.float32)
    return idx, jitter


def log_components(x, pi, mu, cov, tf32: bool = False) -> torch.Tensor:
    """(C, N, K): log pi_k + log N(x_n | mu_k, diag cov_k) of every fit;
    ``tf32`` takes the products in TF32 (the control's E-step)."""
    if tf32:
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return log_components(x, pi, mu, cov)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
    d = x.shape[-1]
    inv = 1.0 / cov                                           # (C, K, d)
    maha = (x.square() @ inv.transpose(1, 2)
            - 2.0 * (x @ (mu * inv).transpose(1, 2))
            + (mu.square() * inv).sum(-1)[:, None, :])
    logdet = cov.log().sum(-1)[:, None, :]
    logpi = pi.clamp_min(1e-20).log()[:, None, :]
    return logpi - 0.5 * (d * LOG2PI + logdet + maha)


@torch.no_grad()
def fit_client(feats: torch.Tensor, labels: torch.Tensor, n_classes: int,
               gmm: Dict, generator: torch.Generator, tf32_estep: bool = False
               ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """One client's class-wise mixtures: ({pi (C, K), mu (C, K, d),
    cov (C, K, d)} float32, mean log-likelihoods (C,)).  ``gmm`` holds K,
    n_iter, kmeans_iter and reg; ``tf32_estep`` computes the E-step's log
    densities with TF32 products, the rest in float32."""
    K, reg = gmm["K"], gmm["reg"]
    x = feats.float()
    N, d = x.shape
    w = class_weights(labels, n_classes)
    idx, jitter = kmeans_draws(w, K, d, generator)
    xsq = x.square()
    xsq_rows = xsq.sum(-1)

    mu = x[idx] + 1e-3 * jitter                               # (C, K, d)
    for _ in range(gmm["kmeans_iter"]):
        d2 = (xsq_rows[None, :, None] - 2 * (x @ mu.transpose(1, 2))
              + mu.square().sum(-1)[:, None, :])
        assign = torch.nn.functional.one_hot(d2.argmin(-1), K).float() \
            * w[..., None]                                    # (C, N, K)
        cnt = assign.sum(1)
        new_mu = (assign.transpose(1, 2) @ x) / cnt.clamp_min(1e-12)[..., None]
        mu = torch.where((cnt > 1e-12)[..., None], new_mu, mu)

    wsum = w.sum(-1).clamp_min(1e-12)
    mean = (w @ x) / wsum[:, None]
    var = ((w[..., None] * (x[None] - mean[:, None]).square()).sum(1)
           / wsum[:, None] + reg)
    cov = var[:, None].expand(-1, K, -1).contiguous()
    pi = torch.full((n_classes, K), 1.0 / K, device=x.device)

    for _ in range(gmm["n_iter"]):
        lr = log_components(x, pi, mu, cov, tf32_estep)
        resp = torch.exp(lr - torch.logsumexp(lr, -1, keepdim=True)) \
            * w[..., None]
        nk = resp.sum(1)
        pi = nk / nk.sum(-1, keepdim=True).clamp_min(1e-12)
        nk_safe = nk.clamp_min(1e-12)[..., None]
        mu = (resp.transpose(1, 2) @ x) / nk_safe
        cov = (resp.transpose(1, 2) @ xsq) / nk_safe - mu.square() + reg
    norm = torch.logsumexp(log_components(x, pi, mu, cov, tf32_estep), -1)
    ll = (norm * w).sum(-1) / wsum
    return {"pi": pi, "mu": mu, "cov": cov}, ll


@torch.no_grad()
def mean_loglik(feats: torch.Tensor, labels: torch.Tensor, n_classes: int,
                mix: Dict[str, torch.Tensor]) -> torch.Tensor:
    """(C,) mean log-likelihood of each class's rows under its mixture."""
    x = feats.float()
    w = class_weights(labels, n_classes)
    norm = torch.logsumexp(log_components(x, mix["pi"], mix["mu"],
                                          mix["cov"]), -1)
    return (norm * w).sum(-1) / w.sum(-1).clamp_min(1e-12)


@torch.no_grad()
def em_gain(feats: torch.Tensor, labels: torch.Tensor, n_classes: int,
            mix: Dict[str, torch.Tensor], reg: float) -> torch.Tensor:
    """(C,) what one plain EM step from ``mix`` adds to each class's mean
    log-likelihood, in nats a row: little where EM has fitted the mixture,
    much where it was left at its start.  The step's variances are taken
    about the new means, component by component."""
    x = feats.float()
    w = class_weights(labels, n_classes)
    lr = log_components(x, mix["pi"], mix["mu"], mix["cov"])
    resp = torch.softmax(lr, -1) * w[..., None]              # (C, N, K)
    nk = resp.sum(1)
    nk_safe = nk.clamp_min(1e-12)
    pi = nk / nk.sum(-1, keepdim=True).clamp_min(1e-12)
    mu = (resp.transpose(1, 2) @ x) / nk_safe[..., None]      # (C, K, d)
    cov = torch.stack([
        (resp[:, :, k, None] * (x[None] - mu[:, k, None]).square()).sum(1)
        for k in range(mu.shape[1])], 1) / nk_safe[..., None] + reg
    after = mean_loglik(feats, labels, n_classes,
                        {"pi": pi, "mu": mu, "cov": cov})
    return after - mean_loglik(feats, labels, n_classes, mix)
