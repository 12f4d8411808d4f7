"""Feature-inversion reconstruction attack (paper §6.4 / Appendix E; port
of ``repro/core/reconstruction.py``).

The paper trains a conditional diffusion model to invert features; here,
as in the reference, a learned linear (ridge) inversion feature → input
fit on the attacker's in-distribution data stands in.  Weaker in absolute
fidelity but order-preserving: raw features reconstruct far better than
GMM-sampled or DP-noised ones, which is the claim under test.  Set-level
metrics follow Appendix E: every target is matched to its closest
reconstruction, and the top-q% ("Oracle") and the mean ("Oracle-all")
are reported.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AttackConfig:
    ridge: float = 1e-2
    top_quantile: float = 0.01   # "Oracle" selection (top 1%)


def fit_inversion(feats: torch.Tensor, inputs: torch.Tensor,
                  cfg: AttackConfig) -> Dict:
    """Closed-form ridge regression feature → input: feats (N, d), inputs
    (N, p); runs where ``feats`` lies."""
    F = feats.float()
    X = torch.as_tensor(inputs).to(F.device).float()
    Fm, Xm = F.mean(0), X.mean(0)
    Fc, Xc = F - Fm, X - Xm
    d = F.shape[1]
    W = torch.linalg.solve(Fc.T @ Fc + cfg.ridge * torch.eye(d,
                                                             device=F.device),
                           Fc.T @ Xc)
    return {"W": W, "f_mean": Fm, "x_mean": Xm}


def invert(attack: Dict, feats: torch.Tensor) -> torch.Tensor:
    return (feats.float() - attack["f_mean"]) @ attack["W"] \
        + attack["x_mean"]


def psnr(x: torch.Tensor, y: torch.Tensor, data_range: float
         ) -> torch.Tensor:
    mse = (x - y).square().mean(-1)
    return 10.0 * torch.log10(data_range ** 2 / mse.clamp_min(1e-12))


def set_level_match(recons: torch.Tensor, targets: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each target, the index and distance of its closest
    reconstruction."""
    r2 = recons.square().sum(-1)
    t2 = targets.square().sum(-1)
    d2 = t2[:, None] - 2.0 * targets @ recons.T + r2[None, :]
    idx = d2.argmin(-1)
    best = d2[torch.arange(idx.shape[0], device=idx.device), idx]
    return idx, best.clamp_min(0.0).sqrt()


def evaluate_attack(attack: Dict, shared_feats: torch.Tensor,
                    target_inputs: torch.Tensor, cfg: AttackConfig,
                    data_range: float = 4.0) -> Dict[str, float]:
    """Set-level reconstruction of ``target_inputs`` from whatever feature
    set the defender shared (raw, GMM samples, DP samples)."""
    recons = invert(attack, shared_feats)
    targets = torch.as_tensor(target_inputs).to(recons.device).float()
    idx, _ = set_level_match(recons, targets)
    matched = recons[idx]
    p = psnr(matched, targets, data_range)                    # (N,)
    mse = (matched - targets).square().mean(-1)
    cos = (matched * targets).sum(-1) / (
        matched.norm(dim=-1) * targets.norm(dim=-1)).clamp_min(1e-9)
    q = max(1, int(p.shape[0] * cfg.top_quantile))
    top = torch.argsort(-p)[:q]
    return {"psnr_all": float(p.mean()), "psnr_oracle": float(p[top].mean()),
            "mse_all": float(mse.mean()), "cosine_all": float(cos.mean()),
            "cosine_oracle": float(cos[top].mean())}
