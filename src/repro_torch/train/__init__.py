"""Training step (port of ``repro/train/__init__.py``): loss → gradients →
optimizer, with optional gradient-accumulation microbatching.

``make_train_step`` returns ``train_step(params, opt_state, batch)`` →
(params, opt_state, metrics), the reference's contract, with one
difference the card needs: the step updates ``params`` and ``opt_state``
in place (``Optimizer.update_``) and returns them, as the reference's
launcher donates both to its jitted step (``donate_argnums=(0, 1)``); a
caller that needs the old values clones them first.  Gradients come from
``torch.autograd.grad`` of ``models.model.loss_fn``: on the card the
attention runs the hand-written flash forward and backward kernels, on
the CPU autograd differentiates the plain versions.  Metrics are 0-d
tensors on the parameters' device (no host sync): ``loss``, ``xent``,
``aux`` and ``grad_norm``.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch import optim
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig


def loss_and_grads(cfg: ModelConfig, params, batch, window: int = 0):
    """(loss, metrics, gradient tree in the parameters' dtypes) of
    ``loss_fn`` at ``params`` (the reference's ``value_and_grad``); the
    parameters themselves stay out of any graph."""
    with torch.enable_grad():
        live = optim.tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, metrics = M.loss_fn(cfg, live, batch, window)
        grads = iter(torch.autograd.grad(loss, optim.tree_leaves(live)))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            optim.tree_map(lambda p: next(grads), params))


def make_train_step(cfg: ModelConfig, optimizer: optim.Optimizer,
                    window: int = 0, microbatch: int = 0) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics).  ``microbatch`` > 0 accumulates f32 gradients over the
    B / microbatch slices of rows in order (the reference's ``lax.scan``),
    and reports the mean loss as ``xent`` and ``aux`` as 0."""

    def train_step(params, opt_state, batch: Dict[str, torch.Tensor]):
        if microbatch:
            B = next(iter(batch.values())).shape[0]
            n_micro = B // microbatch
            loss, grads = 0.0, None
            for i in range(n_micro):
                mb = {k: v[i * microbatch:(i + 1) * microbatch]
                      for k, v in batch.items()}
                li, _, gi = loss_and_grads(cfg, params, mb, window)
                loss = loss + li
                grads = (optim.tree_map(lambda g: g.float(), gi)
                         if grads is None else
                         optim.tree_map(lambda a, g: a.add_(g), grads, gi))
            loss = loss / n_micro
            grads = optim.tree_map(lambda g: g / n_micro, grads)
            metrics = {"xent": loss, "aux": torch.zeros_like(loss)}
        else:
            loss, metrics, grads = loss_and_grads(cfg, params, batch, window)
        gnorm = torch.stack([g.float().square().sum()
                             for g in optim.tree_leaves(grads)]).sum().sqrt()
        opt_state = optimizer.update_(grads, opt_state, params)
        return params, opt_state, dict(metrics, loss=loss, grad_norm=gnorm)

    return train_step


def make_eval_step(cfg: ModelConfig, window: int = 0) -> Callable:
    """Returns eval_step(params, batch) -> metrics: ``loss_fn`` without a
    graph (``loss``, ``xent``, ``aux``)."""
    @torch.no_grad()
    def eval_step(params, batch):
        loss, metrics = M.loss_fn(cfg, params, batch, window)
        return dict(metrics, loss=loss)
    return eval_step
