"""FedPFT — one-shot FL via parametric feature transfer (port of
``repro/core/fedpft.py``).

The paper's Algorithm 1 through ``fl.api.FedSession(topology=Star())``:
clients fit one GMM per present class over foundation features, the GMMs
cross a real 16-bit wire, and the server trains the classifier head from
the decoded mixtures.  ``centralized_baseline`` is the paper's oracle:
the head trained on the pooled real features.  ``client_update`` /
``synthesize`` / ``server_aggregate`` are the v1 surface over raw
(un-encoded) per-class GMMs; they run the same planned synthesis.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
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


@dataclasses.dataclass
class ClientMessage:
    """v1 message: per-class GMMs (stacked over the class axis), sample
    counts (0 = class absent) and the EM mean log-likelihoods."""
    gmms: Dict
    counts: np.ndarray
    logliks: np.ndarray

    def wire_bytes(self, cov_type: str, bytes_per_scalar: int = 2) -> int:
        """Bytes the present classes would take on the wire."""
        C_present = int(np.sum(self.counts > 0))
        d, K = self.gmms["mu"].shape[-1], self.gmms["mu"].shape[-2]
        return G.comm_bytes(cov_type, d, K, C_present, bytes_per_scalar)


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


# ---------------------------------------------------------------------------
# v1 surface: raw per-class GMMs, no wire
# ---------------------------------------------------------------------------


def client_update(feats, labels, n_classes: int, cfg: FedPFTConfig, *,
                  generator: Optional[torch.Generator] = None,
                  device: Optional[str] = None) -> ClientMessage:
    """Algorithm 1, lines 5-10, for one client.  Entry point: runs on
    ``cuda`` unless ``device="cpu"``."""
    dev = resolve_device(device)
    feats = maybe_normalize(torch.as_tensor(feats).to(dev).float(), cfg)
    gmms, counts, lls = G.fit_classwise_gmms(
        feats, torch.as_tensor(labels).to(dev), n_classes, cfg.gmm,
        device=dev, generator=generator)
    return ClientMessage(gmms=gmms,
                         counts=np.asarray(counts.cpu(), np.float64)
                         .astype(np.int64),
                         logliks=np.asarray(lls.cpu()))


def _message_gmms(msg) -> Dict:
    """Parameters of a v1 (``gmms``) or an encoded (``params``) message."""
    return msg.gmms if hasattr(msg, "gmms") else msg.params


def synthesize(messages, cov_type: str,
               samples_per_class: Optional[int] = None, *,
               generator: Optional[torch.Generator] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Algorithm 1, lines 13-16: |F^{i,c}| draws from every g^{i,c},
    through the count-stratified planner (``fl.api.synthesize_groups``)."""
    from repro_torch.fl import api as FA
    return FA.synthesize_groups(
        [(_message_gmms(m), m.counts, cov_type) for m in messages],
        samples_per_class, generator=generator)


def server_aggregate(messages, n_classes: int, cfg: FedPFTConfig, *,
                     generator: Optional[torch.Generator] = None
                     ) -> Tuple[Dict, Dict]:
    """Algorithm 1, lines 12-18: synthesize, then train the global head;
    runs where the messages' parameters lie.  Returns (head, info) with
    the synthetic set and the one-shot bytes."""
    feats, labels = synthesize(messages, cfg.gmm.cov_type,
                               generator=generator)
    head_params, losses = H.train_head(feats, labels, n_classes, cfg.head,
                                       generator=generator)
    comm = sum(m.comm_bytes if hasattr(m, "comm_bytes")
               else m.wire_bytes(cfg.gmm.cov_type, cfg.bytes_per_scalar)
               for m in messages)
    return head_params, {"synthetic_feats": feats, "synthetic_labels": labels,
                         "head_losses": losses, "comm_bytes": comm}


# ---------------------------------------------------------------------------
# the one-shot round through FedSession
# ---------------------------------------------------------------------------


def session_for(n_classes: int, cfg: FedPFTConfig,
                client_cfgs: Optional[Sequence[FedPFTConfig]] = None,
                **overrides):
    """The :class:`repro_torch.fl.api.FedSession` equivalent of a config;
    ``overrides`` (``dp=``, ``topology=``, …) pass through.
    ``client_cfgs`` give clients their own K / covariance family (§6.3)."""
    from repro_torch.fl import api as FA
    wire_by_width = {2: "bfloat16", 4: "float32"}
    if cfg.bytes_per_scalar not in wire_by_width:
        raise ValueError(f"no wire dtype for bytes_per_scalar="
                         f"{cfg.bytes_per_scalar}")
    kw = dict(n_classes=n_classes, summarizer=FA.GMMSummarizer(cfg.gmm),
              codec=FA.QuantizedCodec(wire_by_width[cfg.bytes_per_scalar]),
              head=cfg.head, normalize_features=cfg.normalize_features)
    if client_cfgs is not None:
        # wire precision and normalization are session-wide
        if any(c.bytes_per_scalar != cfg.bytes_per_scalar
               or c.normalize_features != cfg.normalize_features
               for c in client_cfgs):
            raise ValueError("per-client bytes_per_scalar/normalize_features"
                             " are not supported; vary gmm only")
        kw["client_summarizers"] = tuple(FA.GMMSummarizer(c.gmm)
                                         for c in client_cfgs)
    kw.update(overrides)
    return FA.FedSession(**kw)


def run_fedpft(client_datasets: Sequence[Tuple[torch.Tensor, torch.Tensor]],
               n_classes: int, cfg: FedPFTConfig,
               client_cfgs: Optional[Sequence[FedPFTConfig]] = None, *,
               seed: int = 0, device: Optional[str] = None
               ) -> Tuple[Dict, Dict]:
    """One-shot FedPFT over ``[(feats_i, labels_i)]``: (head, info).
    Entry point: runs on ``cuda`` unless ``device="cpu"``."""
    if client_cfgs is not None and len(client_cfgs) != len(client_datasets):
        raise ValueError("one client config per client")
    res = session_for(n_classes, cfg, client_cfgs).run(
        client_datasets, seed=seed, device=device)
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
