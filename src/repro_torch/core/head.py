"""Linear classifier head over features (port of ``repro/core/head.py``).

The head ``h`` of the paper's ``w = h ∘ f`` is a (d, C) linear layer
trained with Adam + cross-entropy, on a materialized pool of real or
synthetic features (:func:`train_head`), on the planner's synthetic
chunks without pooling them (:func:`train_head_streaming`), or straight
from the decoded mixture-slot stack (:func:`train_head_from_gmms`): every
step draws its minibatch from the mixtures, so the pooled synthetic set
never exists.  The head is tiny, so its gradient is plain autograd.

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


# round-robin passes over the chunk list in train_head_streaming: bounds
# the gap between two visits to the same chunk by ≈ n_steps/_INTERLEAVE
_INTERLEAVE = 4


def _streaming_segment(params: Params, opt_state, opt, feats, labels, idx,
                       bs: int):
    """The steps of one chunk's segment: each minibatch is ``bs`` rows of
    the chunk (padded past a short chunk with weight-0 rows)."""
    w = (torch.arange(bs, device=feats.device)
         < min(bs, feats.shape[0])).float()
    losses = []
    for rows in idx:
        params, opt_state, loss = _adam_step(params, opt_state, opt,
                                             feats[rows], labels[rows], w)
        losses.append(loss)
    return params, opt_state, losses


@torch.no_grad()
def train_head_streaming(chunks, n_classes: int, cfg: HeadConfig, *,
                         generator: Optional[torch.Generator] = None,
                         draws: Optional[Dict[str, torch.Tensor]] = None
                         ) -> Tuple[Params, torch.Tensor]:
    """Train a head over (feats, labels) chunks without pooling them; runs
    where the chunks lie.

    Steps go to chunks ∝ row count (largest remainder of
    ``n_steps·size/Σsize``), each minibatch drawn uniformly within its
    chunk; each chunk's steps are split into ``_INTERLEAVE`` segments run
    round-robin over the chunks, so a class living in one small chunk is
    revisited every ≈ ``n_steps/_INTERLEAVE`` steps.  Optimizer state
    carries across segments; losses come back in execution order.
    ``draws`` replaces the draws: ``init`` (d, C) and ``idx`` (n_steps,
    batch_size), row t the rows of the t-th step in allocation order
    (chunk by chunk).  A chunk list with no rows returns the initialized
    head and no losses.
    """
    if not chunks:
        raise ValueError("train_head_streaming needs at least one chunk "
                         "(the feature dim is unknowable from [])")
    d, dev = int(chunks[0][0].shape[1]), chunks[0][0].device
    chunks = [(f.float(), y) for f, y in chunks if int(f.shape[0]) > 0]
    dims = sorted({int(f.shape[1]) for f, _ in chunks})
    if len(dims) > 1:
        raise ValueError(
            f"train_head_streaming: chunks disagree on the feature dim "
            f"(saw d ∈ {dims}) — one head cannot train over mixed feature "
            "spaces; synthesize each cohort group separately")
    d = dims[0] if dims else d
    init = None if draws is None else draws["init"]
    params = init_head(d, n_classes, generator=generator, normal=init,
                       device=dev)
    if not chunks:
        return params, _stack([], dev)
    sizes = np.asarray([int(f.shape[0]) for f, _ in chunks], np.float64)
    raw = sizes / sizes.sum() * cfg.n_steps
    n_per = np.floor(raw).astype(np.int64)
    short = cfg.n_steps - int(n_per.sum())
    if short:
        n_per[np.argsort(-(raw - np.floor(raw)))[:short]] += 1
    offsets = np.concatenate([[0], np.cumsum(n_per)])
    bs = cfg.batch_size
    opt = optim.adam(cfg.lr, weight_decay=cfg.weight_decay)
    opt_state = opt.init(params)
    losses = []
    for r in range(_INTERLEAVE):
        for j, (f, y) in enumerate(chunks):
            lo = int(offsets[j]) + int(n_per[j] * r // _INTERLEAVE)
            hi = int(offsets[j]) + int(n_per[j] * (r + 1) // _INTERLEAVE)
            if hi == lo:
                continue
            if draws is None:
                idx = torch.randint(0, f.shape[0], (hi - lo, bs),
                                    generator=generator, device=dev)
            else:
                idx = draws["idx"][lo:hi].to(dev).long()
            params, opt_state, seg = _streaming_segment(
                params, opt_state, opt, f, y.to(dev), idx, bs)
            losses += seg
    return params, _stack(losses, dev)


def categorical(probs: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """One index per row of ``probs`` (n, K), ∝ the row: the exponential
    race argmax(p / E), E ~ Exp(1).  This is what
    ``torch.multinomial(probs, 1)`` computes, draw for draw, without the
    argument checks that wait on the device, so it can run inside a CUDA
    graph capture."""
    race = torch.empty_like(probs).exponential_(1.0, generator=generator)
    return (probs / race).argmax(-1)


@torch.no_grad()
def fused_gmm_steps(pi, mu, cov, slot_labels, counts, n_classes: int,
                    cfg: HeadConfig, cov_type: str, *,
                    generator: Optional[torch.Generator] = None,
                    draws: Optional[Dict[str, torch.Tensor]] = None
                    ) -> Tuple[Params, torch.Tensor]:
    """The server phase: Adam steps whose minibatches are drawn from the
    flat (G, K, …) slot stack — slot ∝ counts, component ∝ pi, Gaussian
    through the sampling factor — with the noise drawn ``noise_window``
    steps at a time.  Runs where ``mu`` lies.  Full covariance groups each
    window's draws by (slot, component) (``gmm.factor_noise``): memory
    O(window·batch·d + slot stack), never a d × d factor per draw.

    ``draws`` replaces every draw: ``init`` (d, C), ``slot_all`` and
    ``comp_all`` (n_steps·batch,), ``eps`` (n_steps, batch, d).

    Nothing in the step loop waits on the device (the component draw is
    :func:`categorical`, the losses fill a preallocated (n_steps,)
    tensor, the Adam bias corrections are host floats of the step count),
    so for diag and spher mixtures the whole call can be captured as one
    CUDA graph (``launch.aot_cache``); with the draws from the default
    CUDA generator a replay makes the draws an eager call makes.  Full
    covariance groups its draws by data-dependent sizes and cannot be
    captured.
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
        comp_all = categorical(pi.float().clamp_min(1e-20)[slot_all],
                               generator)
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
    losses = torch.empty((cfg.n_steps,), dtype=torch.float32, device=dev)
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
            params, opt_state, losses[step + i] = _adam_step(
                params, opt_state, opt, x[i], y[i], ones)
        step += width
    return params, losses


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


def accuracy(params: Params, feats: torch.Tensor, labels: torch.Tensor,
             weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    pred = head_logits(params, feats).argmax(-1)
    hit = (pred == labels.to(pred.device)).float()
    if weights is None:
        return hit.mean()
    weights = weights.to(hit.device).float()
    return (hit * weights).sum() / weights.sum().clamp_min(1e-9)


def classwise_01_loss(params: Params, feats: torch.Tensor,
                      labels: torch.Tensor, n_classes: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-class 0-1 loss and class counts, (C,) each (Theorem 6.1)."""
    pred = head_logits(params, feats).argmax(-1)
    labels = labels.to(pred.device).long()
    miss = (pred != labels).float()
    onehot = (labels[:, None] == torch.arange(n_classes,
                                              device=pred.device)).float()
    cnt = onehot.sum(0)
    return (miss @ onehot) / cnt.clamp_min(1.0), cnt
