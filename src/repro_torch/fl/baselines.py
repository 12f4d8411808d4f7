"""Multi-round and one-shot FL baselines over classifier heads (port of
``repro/fl/baselines.py``).

The one-shot aggregators (``avg_heads`` / ``ensemble_predict`` /
``fedbe``) are the server side of ``FedSession(summarizer=
HeadSummarizer(), aggregate="avg" | "ensemble" | "fedbe")``: clients ship
codec-encoded heads through the same wire as GMM summaries.  The
multi-round methods (FedAvg, FedProx, FedYogi, DSFL) are :func:`fedavg`.

Every draw comes from a ``torch.Generator`` or is passed in as tensors
(minibatch indices, head init, FedBE's posterior noise), so tests can feed
the reference's draws.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import optim, resolve_device
from repro_torch.core import head as H

Params = Dict[str, torch.Tensor]


def head_comm_bytes(d: int, n_classes: int, bytes_per_scalar: int = 2) -> int:
    return (n_classes * d + n_classes) * bytes_per_scalar


# ---------------------------------------------------------------------------
# local training (shared by every baseline)
# ---------------------------------------------------------------------------


def _adam_steps(params: Params, loss_fn, idx: torch.Tensor, lr: float
                ) -> Params:
    """Adam over the minibatches ``idx`` (n_steps, bs) of row indices."""
    opt = optim.adam(lr)
    state = opt.init(params)
    for rows in idx:
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        with torch.enable_grad():
            grads = torch.autograd.grad(loss_fn(leaves, rows),
                                        list(leaves.values()))
        upd, state = opt.update(dict(zip(leaves, grads)), state, params)
        params = optim.apply_updates(params, upd)
    return params


def _indices(n_rows: int, n_steps: int, bs: int, generator, device,
             idx: Optional[torch.Tensor]) -> torch.Tensor:
    if idx is not None:
        return idx.to(device).long()
    return torch.randint(0, n_rows, (n_steps, bs), generator=generator,
                         device=device)


def _ce(params: Params, f: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    lp = torch.log_softmax(H.head_logits(params, f), dim=-1)
    return -lp.gather(-1, y.long()[:, None])[:, 0].mean()


@torch.no_grad()
def local_train(head0: Params, feats: torch.Tensor, labels: torch.Tensor,
                n_classes: int, n_steps: int = 100, batch_size: int = 256,
                lr: float = 1e-3, prox: float = 0.0, *,
                generator: Optional[torch.Generator] = None,
                idx: Optional[torch.Tensor] = None) -> Params:
    """Adam local steps from a given head; runs where ``feats`` lies.
    ``prox`` > 0 adds FedProx's (μ/2)·||w − w_global||².  ``idx``
    (n_steps, min(batch_size, N)) replaces the minibatch draws."""
    feats = feats.float()
    labels = labels.to(feats.device)
    bs = min(batch_size, feats.shape[0])
    anchor = {k: v.detach() for k, v in head0.items()}

    def loss_fn(p, rows):
        loss = _ce(p, feats[rows], labels[rows])
        if prox:
            loss = loss + 0.5 * prox * sum(
                (p[k] - anchor[k]).square().sum() for k in sorted(p))
        return loss

    return _adam_steps(dict(head0), loss_fn,
                       _indices(feats.shape[0], n_steps, bs, generator,
                                feats.device, idx), lr)


# ---------------------------------------------------------------------------
# one-shot aggregators
# ---------------------------------------------------------------------------


def avg_heads(heads: Sequence[Params],
              weights: Optional[Sequence[float]] = None) -> Params:
    """AVG baseline: (weighted) parameter mean of locally trained heads."""
    if weights is None:
        weights = [1.0] * len(heads)
    w = torch.tensor(weights, dtype=torch.float32)
    w = w / w.sum()
    out = {}
    for k in heads[0]:
        stack = torch.stack([h[k] for h in heads])
        out[k] = (stack * w.to(stack.device).reshape(
            (-1,) + (1,) * (stack.dim() - 1))).sum(0)
    return out


def ensemble_predict(heads: Sequence[Params], feats: torch.Tensor
                     ) -> torch.Tensor:
    """Ensemble baseline: average class probabilities, then argmax."""
    probs = sum(torch.softmax(H.head_logits(h, feats), -1) for h in heads)
    return probs.argmax(-1)


def fedbe(heads: Sequence[Params], n_samples: int = 15, *,
          generator: Optional[torch.Generator] = None,
          eps: Optional[Sequence[Params]] = None) -> List[Params]:
    """FedBE: heads sampled from a Gaussian posterior over the client heads
    (mean, per-parameter population variance + 1e-8), ensembled with the
    clients' own (Chen & Chao, 2020).  ``eps``: one standard-normal dict
    per sample, each leaf its own draw."""
    mean = avg_heads(heads)
    var = {k: torch.stack([h[k] for h in heads]).var(0, unbiased=False)
           + 1e-8 for k in mean}
    samples = []
    for s in range(n_samples):
        if eps is None:
            e = {k: torch.randn(m.shape, generator=generator,
                                device=m.device, dtype=torch.float32)
                 for k, m in sorted(mean.items())}
        else:
            e = {k: v.to(mean[k].device, torch.float32)
                 for k, v in eps[s].items()}
        samples.append({k: mean[k] + var[k].sqrt() * e[k] for k in mean})
    return list(heads) + samples


@torch.no_grad()
def kd_transfer(teacher: Params, student0: Params, feats: torch.Tensor,
                labels: torch.Tensor, n_classes: int, n_steps: int = 200,
                lr: float = 1e-3, temperature: float = 5.0,
                alpha: float = 0.5, *,
                generator: Optional[torch.Generator] = None,
                idx: Optional[torch.Tensor] = None) -> Params:
    """KD baseline (§5.3): distill the received (source) head into the
    local one on the destination's own features.  ``idx`` (n_steps,
    min(256, N)) replaces the minibatch draws."""
    feats = feats.float()
    labels = labels.to(feats.device)
    t_probs = torch.softmax(H.head_logits(teacher, feats) / temperature, -1)

    def loss_fn(p, rows):
        logits = H.head_logits(p, feats[rows])
        ce = _ce(p, feats[rows], labels[rows])
        kd = -(t_probs[rows] * torch.log_softmax(logits / temperature, -1)
               ).sum(-1).mean()
        return alpha * ce + (1 - alpha) * kd * temperature ** 2

    bs = min(256, feats.shape[0])
    return _adam_steps(dict(student0), loss_fn,
                       _indices(feats.shape[0], n_steps, bs, generator,
                                feats.device, idx), lr)


# ---------------------------------------------------------------------------
# multi-round methods
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MultiRoundConfig:
    rounds: int = 10
    local_steps: int = 50
    lr: float = 1e-2
    prox: float = 0.0            # FedProx μ
    server: str = "avg"          # "avg" | "yogi"
    server_lr: float = 1e-2      # FedYogi η
    topk_frac: float = 0.0       # DSFL sparsification (0 = dense)
    bytes_per_scalar: int = 2


def _sparsify(delta: Params, frac: float) -> Params:
    """DSFL: keep only the top-|frac| entries of the update by magnitude
    (ties at the threshold kept)."""
    keys = sorted(delta)
    vec = torch.cat([delta[k].reshape(-1) for k in keys])
    k = max(1, int(vec.numel() * frac))
    thresh = torch.sort(vec.abs()).values[-k]
    return {n: torch.where(delta[n].abs() >= thresh, delta[n],
                           torch.zeros_like(delta[n])) for n in keys}


@torch.no_grad()
def fedavg(client_datasets: Sequence[Tuple], n_classes: int,
           cfg: MultiRoundConfig, *, seed: int = 0, device=None,
           draws: Optional[Dict] = None) -> Tuple[Params, Dict]:
    """FedAvg / FedProx / FedYogi / DSFL, chosen by ``cfg``.  Entry point:
    runs on ``cuda`` unless ``device="cpu"``.  ``draws``: ``init`` (d, C)
    and ``idx[r][i]`` (local_steps, min(256, N_i)), client i's minibatches
    in round r.  Returns (global head, info with the comm bytes)."""
    dev = resolve_device(device)
    data = [(torch.as_tensor(f).to(dev).float(),
             torch.as_tensor(y).to(dev).long()) for f, y in client_datasets]
    d = int(data[0][0].shape[1])
    sizes = np.array([len(y) for _, y in data], np.float64)
    weights = sizes / sizes.sum()
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)
    global_head = H.init_head(d, n_classes, generator=generator,
                              normal=None if draws is None else draws["init"],
                              device=dev)
    server_opt = optim.yogi(cfg.server_lr) if cfg.server == "yogi" else None
    server_state = server_opt.init(global_head) if server_opt else None

    per_round = 2 * len(data) * head_comm_bytes(d, n_classes,
                                                cfg.bytes_per_scalar)
    if cfg.topk_frac:
        # uplink sparsified: value + index per kept entry (~2 scalars each)
        n_params = n_classes * d + n_classes
        up = int(n_params * cfg.topk_frac) * 2 * cfg.bytes_per_scalar
        per_round = len(data) * (
            up + head_comm_bytes(d, n_classes, cfg.bytes_per_scalar))

    history = []
    for r in range(cfg.rounds):
        deltas = []
        for i, (f, y) in enumerate(data):
            local = local_train(global_head, f, y, n_classes,
                                n_steps=cfg.local_steps, lr=cfg.lr,
                                prox=cfg.prox, generator=generator,
                                idx=None if draws is None
                                else draws["idx"][r][i])
            delta = {k: local[k] - global_head[k] for k in global_head}
            if cfg.topk_frac:
                delta = _sparsify(delta, cfg.topk_frac)
            deltas.append(delta)
        # weights: host numpy floats (client sizes), no tensor
        mean_delta = {k: sum(float(w) * dl[k] for w, dl in  # lint: disable=HOST-SYNC
                             zip(weights, deltas)) for k in global_head}
        if server_opt:
            # yogi takes −mean_delta as the gradient
            upd, server_state = server_opt.update(
                {k: -g for k, g in mean_delta.items()}, server_state,
                global_head)
            global_head = optim.apply_updates(global_head, upd)
        else:
            global_head = {k: global_head[k] + mean_delta[k]
                           for k in global_head}
        history.append(per_round * (r + 1))
    return global_head, {"comm_bytes": per_round * cfg.rounds,
                         "comm_history": history}
