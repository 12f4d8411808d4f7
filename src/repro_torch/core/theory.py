"""Theory evaluators: the Theorem 6.1 bound and the Eqs. 9-11 cost model
(port of ``repro/core/theory.py``).

Theorem 6.1 (0-1 loss form):
    l_i ≤ E_c[ 2·l~_c − l~_c² + ((1 − l~_c)/√2)·sqrt(H^{i,c} − L_EM^{i,c}) ]

l~_c is the server head's 0-1 loss on client i's synthetic class-c
features, H^{i,c} the (dequantized) self-entropy of the class-c feature
distribution, L_EM the EM mean log-likelihood.  H is estimated with the
Kozachenko–Leonenko 1-NN estimator.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core import gmm as G

EULER_GAMMA = 0.5772156649015329


def entropy_knn(x: torch.Tensor, dequantize_scale: float = 1e-3, *,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kozachenko–Leonenko 1-NN differential-entropy estimate (nats):
    H^ = (d/N)·Σ log r_i + log(N−1) + log V_d + γ.  The paper dequantizes
    the features first (Appendix C.2): uniform noise of scale
    ``dequantize_scale``, drawn from ``generator`` or given as ``noise``
    (N, d) uniforms in [0, 1); with neither, no dequantization."""
    N, d = x.shape
    x = x.float()
    if dequantize_scale > 0 and (noise is not None or generator is not None):
        if noise is None:
            noise = torch.rand(tuple(x.shape), generator=generator,
                               device=x.device)
        x = x + dequantize_scale * noise.to(x.device, torch.float32)
    sq = x.square().sum(-1)
    d2 = sq[:, None] - 2.0 * (x @ x.T) + sq[None, :]
    d2 = d2 + torch.eye(N, device=x.device) * 1e12           # exclude self
    r = d2.min(-1).values.clamp_min(1e-24).sqrt()
    log_vd = (d / 2.0) * math.log(math.pi) - math.lgamma(d / 2.0 + 1.0)
    return (d * r.log().mean() + math.log(float(N - 1)) + log_vd
            + EULER_GAMMA)


def _weights(class_weights: torch.Tensor) -> torch.Tensor:
    return class_weights / class_weights.sum().clamp_min(1e-9)


def theorem61_bound(synth_01_loss: torch.Tensor, H: torch.Tensor,
                    L_EM: torch.Tensor, class_weights: torch.Tensor
                    ) -> torch.Tensor:
    """RHS of Theorem 6.1; every argument is per class (C,)."""
    l = synth_01_loss.clamp(0.0, 1.0)
    gap = (H - L_EM).clamp_min(0.0).sqrt()
    per_class = 2 * l - l.square() + (1 - l) / math.sqrt(2.0) * gap
    return (per_class * _weights(class_weights)).sum()


def accuracy_lower_bound(synth_acc: torch.Tensor, H: torch.Tensor,
                         L_EM: torch.Tensor, class_weights: torch.Tensor
                         ) -> torch.Tensor:
    """Equation (26): Acc(h, F^i) ≥ E_c[acc_c·(acc_c − sqrt((H−L_EM)/2))]."""
    a = synth_acc.clamp(0.0, 1.0)
    gap = ((H - L_EM).clamp_min(0.0) / 2.0).sqrt()
    return (a * (a - gap) * _weights(class_weights)).sum()


# Eqs. 9-11, from the gmm module (one definition)
n_parameters = G.n_parameters
comm_bytes = G.comm_bytes
raw_feature_bytes = G.raw_feature_bytes


def head_bytes(d: int, n_classes: int, bytes_per_scalar: int = 2) -> int:
    """Cost of sending the classifier head itself (Cd + C); §6.3 notes
    Cost(G_spher(K=1)) equals it."""
    return (n_classes * d + n_classes) * bytes_per_scalar
