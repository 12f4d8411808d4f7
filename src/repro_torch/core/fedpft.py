"""FedPFT — one-shot FL via parametric feature transfer (port of
``repro/core/fedpft.py``).

The paper's Algorithm 1 through ``fl.api.FedSession(topology=Star())``:
clients fit one GMM per present class over foundation features, the GMMs
cross a real 16-bit wire, and the server trains the classifier head from
the decoded mixtures.  ``centralized_baseline`` is the paper's oracle:
the head trained on the pooled real features.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.core import gmm as G
from repro_torch.core import head as H


@dataclasses.dataclass(frozen=True)
class FedPFTConfig:
    gmm: G.GMMConfig = G.GMMConfig()
    head: H.HeadConfig = H.HeadConfig()
    bytes_per_scalar: int = 2      # paper's 16-bit encoding
    normalize_features: bool = False  # ||f||₂ ≤ 1 (required for DP)


def pad_client(feats: torch.Tensor, labels: torch.Tensor, n_max: int):
    """Pad to a common row count with label −1 rows, which one-hot to all
    zeros: EM gives them weight 0 and they never influence the fit."""
    n = feats.shape[0]
    if n >= n_max:
        return feats[:n_max], labels[:n_max]
    pf = torch.zeros((n_max - n, feats.shape[1]), dtype=feats.dtype,
                     device=feats.device)
    pl = torch.full((n_max - n,), -1, dtype=labels.dtype,
                    device=labels.device)
    return torch.cat([feats, pf]), torch.cat([labels, pl])


def maybe_normalize(feats: torch.Tensor, cfg: FedPFTConfig) -> torch.Tensor:
    if not cfg.normalize_features:
        return feats
    return feats / feats.norm(dim=-1, keepdim=True).clamp_min(1.0)


def session_for(n_classes: int, cfg: FedPFTConfig, **overrides):
    """The :class:`repro_torch.fl.api.FedSession` equivalent of a config."""
    from repro_torch.fl import api as FA
    wire_by_width = {2: "bfloat16", 4: "float32"}
    if cfg.bytes_per_scalar not in wire_by_width:
        raise ValueError(f"no wire dtype for bytes_per_scalar="
                         f"{cfg.bytes_per_scalar}")
    kw = dict(n_classes=n_classes, summarizer=FA.GMMSummarizer(cfg.gmm),
              codec=FA.QuantizedCodec(wire_by_width[cfg.bytes_per_scalar]),
              head=cfg.head, normalize_features=cfg.normalize_features)
    kw.update(overrides)
    return FA.FedSession(**kw)


def run_fedpft(client_datasets: Sequence[Tuple[torch.Tensor, torch.Tensor]],
               n_classes: int, cfg: FedPFTConfig, *, seed: int = 0,
               device: Optional[str] = None) -> Tuple[Dict, Dict]:
    """One-shot FedPFT over ``[(feats_i, labels_i)]``: (head, info).
    Entry point: runs on ``cuda`` unless ``device="cpu"``."""
    res = session_for(n_classes, cfg).run(client_datasets, seed=seed,
                                          device=device)
    info = dict(res.info)
    info["messages"] = res.messages
    return res.model, info


def centralized_baseline(client_datasets, n_classes: int, cfg: FedPFTConfig,
                         *, seed: int = 0, device: Optional[str] = None
                         ) -> Tuple[Dict, Dict]:
    """The paper's oracle: ship raw features, train on the real pool."""
    dev = resolve_device(device)
    feats = torch.cat([torch.as_tensor(f).to(dev).float()
                       for f, _ in client_datasets])
    labels = torch.cat([torch.as_tensor(y).to(dev).long()
                        for _, y in client_datasets])
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)
    head_params, losses = H.train_head(maybe_normalize(feats, cfg), labels,
                                       n_classes, cfg.head,
                                       generator=generator)
    comm = sum(G.raw_feature_bytes(int(f.shape[0]), int(f.shape[1]),
                                   cfg.bytes_per_scalar)
               for f, _ in client_datasets)
    return head_params, {"comm_bytes": comm, "head_losses": losses}
