"""Linear classifier head over features (port of ``repro/core/head.py``).

The head ``h`` of the paper's ``w = h ∘ f`` is a (d, C) linear layer
trained with Adam + cross-entropy, either on real features (the
centralized oracle, :func:`train_head`) or straight from the decoded
mixture-slot stack (:func:`train_head_from_gmms`): every step draws its
minibatch from the mixtures, so the pooled synthetic set never exists.
The head is tiny, so its gradient is plain autograd.

Random draws come from an explicit ``torch.Generator`` or are passed in
as tensors (``draws``), so tests can feed the reference's draws to both.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import optim, resolve_device
from repro_torch.core import gmm as G

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class HeadConfig:
    n_steps: int = 500
    batch_size: int = 256
    lr: float = 1e-3          # paper: Adam 1e-4; higher works for linear head
    weight_decay: float = 0.0
    noise_window: int = 32    # Gaussian noise is drawn in (window, batch, d)
    #   blocks: big-batch RNG throughput, O(window·batch·d) memory


def init_head(d: int, n_classes: int, *,
              generator: Optional[torch.Generator] = None,
              normal: Optional[torch.Tensor] = None,
              device=None) -> Params:
    """w = 0.01·N(0, 1)/√d, b = 0.  ``normal`` (d, C) replaces the draw."""
    if normal is None:
        normal = torch.randn((d, n_classes), generator=generator,
                             device=device, dtype=torch.float32)
    w = normal.to(device=device, dtype=torch.float32) / math.sqrt(d)
    return {"w": w * 0.01,
            "b": torch.zeros((n_classes,), dtype=torch.float32,
                             device=w.device)}


def head_logits(params: Params, feats: torch.Tensor) -> torch.Tensor:
    return feats.float() @ params["w"] + params["b"]


def _xent(params: Params, feats, labels, weights) -> torch.Tensor:
    lp = torch.log_softmax(head_logits(params, feats), dim=-1)
    ll = lp.gather(-1, labels.long()[:, None])[:, 0]
    return -(ll * weights).sum() / weights.sum().clamp_min(1e-9)


def _adam_step(params: Params, opt_state, opt, x, y, weights):
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        loss = _xent(leaves, x, y, weights)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    updates, opt_state = opt.update(dict(zip(leaves, grads)), opt_state,
                                    params)
    return optim.apply_updates(params, updates), opt_state, loss.detach()


def _stack(losses, device) -> torch.Tensor:
    if not losses:
        return torch.zeros((0,), dtype=torch.float32, device=device)
    return torch.stack(losses)


@torch.no_grad()
def train_head(feats: torch.Tensor, labels: torch.Tensor, n_classes: int,
               cfg: HeadConfig, *,
               generator: Optional[torch.Generator] = None,
               draws: Optional[Dict[str, torch.Tensor]] = None
               ) -> Tuple[Params, torch.Tensor]:
    """Train a head on (feats, labels); runs where ``feats`` lies.

    Minibatch rows are drawn uniformly.  Draws: ``generator``, or ``draws``
    with ``init`` (d, C) and ``idx`` (n_steps, batch) row indices.  Returns
    (head params, per-step losses); an empty pool returns the initialized
    head and no losses.
    """
    N, d = feats.shape
    dev = feats.device
    init = None if draws is None else draws["init"]
    params = init_head(d, n_classes, generator=generator, normal=init,
                       device=dev)
    if N == 0:
        return params, _stack([], dev)
    feats = feats.float()
    labels = labels.to(dev)
    bs = min(cfg.batch_size, N)
    opt = optim.adam(cfg.lr, weight_decay=cfg.weight_decay)
    opt_state = opt.init(params)
    if draws is not None:
        idx_all = draws["idx"].to(dev)
    else:
        idx_all = torch.randint(0, N, (cfg.n_steps, bs), generator=generator,
                                device=dev)
    ones = torch.ones((bs,), dtype=torch.float32, device=dev)
    losses = []
    for idx in idx_all:
        params, opt_state, loss = _adam_step(params, opt_state, opt,
                                             feats[idx], labels[idx], ones)
        losses.append(loss)
    return params, _stack(losses, dev)


@torch.no_grad()
def fused_gmm_steps(pi, mu, cov, slot_labels, counts, n_classes: int,
                    cfg: HeadConfig, cov_type: str, *,
                    generator: Optional[torch.Generator] = None,
                    draws: Optional[Dict[str, torch.Tensor]] = None
                    ) -> Tuple[Params, torch.Tensor]:
    """The server phase: Adam steps whose minibatches are drawn from the
    flat (G, K, …) slot stack — slot ∝ counts, component ∝ pi, Gaussian
    through the sampling factor — with the noise drawn ``noise_window``
    steps at a time.  Runs where ``mu`` lies.

    ``draws`` replaces every draw: ``init`` (d, C), ``slot_all`` and
    ``comp_all`` (n_steps·batch,), ``eps`` (n_steps, batch, d).
    """
    bs, d = cfg.batch_size, mu.shape[-1]
    dev = mu.device
    W = max(1, min(cfg.noise_window, cfg.n_steps))
    n_win, tail = divmod(cfg.n_steps, W)
    fac = G.sampling_factor(cov, cov_type)                    # (G, K, …)
    if draws is None:
        mass = counts.float()
        cum_mass = torch.cumsum(mass, 0) / mass.sum().clamp_min(1e-9)
        u = torch.rand((cfg.n_steps * bs,), generator=generator, device=dev)
        slot_all = G.draw_slots(u, cum_mass)
        probs = pi.float().clamp_min(1e-20)[slot_all]
        comp_all = torch.multinomial(probs, 1, generator=generator)[:, 0]
        init = None
    else:
        slot_all = draws["slot_all"].to(dev).long()
        comp_all = draws["comp_all"].to(dev).long()
        init = draws["init"]
    params = init_head(d, n_classes, generator=generator, normal=init,
                       device=dev)
    opt = optim.adam(cfg.lr, weight_decay=cfg.weight_decay)
    opt_state = opt.init(params)
    ones = torch.ones((bs,), dtype=torch.float32, device=dev)
    losses = []
    step = 0
    for width in [W] * n_win + ([tail] if tail else []):
        sl = slot_all[step * bs:(step + width) * bs].reshape(width, bs)
        cm = comp_all[step * bs:(step + width) * bs].reshape(width, bs)
        if draws is None:
            eps = torch.randn((width, bs, d), generator=generator,
                              device=dev, dtype=torch.float32)
        else:
            eps = draws["eps"][step:step + width].to(dev, torch.float32)
        x = G.slot_gaussian(sl, cm, eps, mu, fac, cov_type)   # (W', bs, d)
        y = slot_labels[sl]
        for i in range(width):
            params, opt_state, loss = _adam_step(params, opt_state, opt,
                                                 x[i], y[i], ones)
            losses.append(loss)
        step += width
    return params, _stack(losses, dev)


def train_head_from_gmms(pi, mu, cov, slot_labels, counts, n_classes: int,
                         cfg: HeadConfig, cov_type: str, *, device=None,
                         generator: Optional[torch.Generator] = None,
                         draws: Optional[Dict[str, torch.Tensor]] = None
                         ) -> Tuple[Params, torch.Tensor]:
    """Zero-materialization server phase: train the head straight from the
    decoded slot stack (``fl.planner.SlotTable`` order).  Entry point:
    runs on ``cuda`` unless ``device="cpu"``.

    pi (G, K), mu (G, K, d), cov (G, K, …), slot_labels (G,) the class of
    each slot, counts (G,) its draw count.  An empty table (or all-zero
    counts) returns the initialized head and no losses.
    """
    dev = resolve_device(device)
    G_slots = int(np.shape(mu)[0])
    if tuple(np.shape(slot_labels)) != (G_slots,) \
            or tuple(np.shape(counts)) != (G_slots,):
        raise ValueError(
            f"train_head_from_gmms: slot stack has {G_slots} rows but "
            f"slot_labels is {tuple(np.shape(slot_labels))} and counts is "
            f"{tuple(np.shape(counts))} — pass one label and one draw "
            "count per slot row (fl.planner.SlotTable order)")
    if generator is None and draws is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    pi, mu, cov, slot_labels, counts = (
        torch.as_tensor(a).to(dev)
        for a in (pi, mu, cov, slot_labels, counts))
    d = int(mu.shape[-1])
    if G_slots == 0 or float(counts.float().sum()) <= 0.0:
        init = None if draws is None else draws["init"]
        return (init_head(d, n_classes, generator=generator, normal=init,
                          device=dev), _stack([], dev))
    return fused_gmm_steps(pi, mu, cov, slot_labels, counts, n_classes, cfg,
                           cov_type, generator=generator, draws=draws)


def accuracy(params: Params, feats: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
    pred = head_logits(params, feats).argmax(-1)
    return (pred == labels.to(pred.device)).float().mean()
