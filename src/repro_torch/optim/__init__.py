"""Optimizers, written by hand (port of ``repro/optim/__init__.py``).

Each optimizer is an ``(init, update)`` pair over dicts of tensors, with
``apply_updates`` as in the reference; optimizer state is f32 whatever the
parameter dtype.  ``torch.optim`` is not used: the reference adds eps
outside ``sqrt(v / bc2)`` and applies weight decay decoupled, as
``u − lr·wd·p``, where ``torch.optim.Adam(weight_decay=)`` applies coupled
L2.  Provided: sgd (momentum, Nesterov), adam, yogi (FedYogi's server
optimizer) and the cosine / linear-warmup schedules; a learning rate may
be a schedule, called with the step count before the update.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple

import torch

Params = Dict[str, torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def apply_updates(params: Params, updates: Params) -> Params:
    return {k: (p.float() + updates[k]).to(p.dtype) for k, p in params.items()}


def _f32_like(params: Params) -> Params:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def _resolve(lr, count: int) -> float:
    return float(lr(count)) if callable(lr) else lr


def _f32_pow(base: float, c: int) -> float:
    """``1 − base**c`` in f32, as the reference computes bias corrections."""
    one = torch.tensor(1.0, dtype=torch.float32)
    return float(one - torch.tensor(base, dtype=torch.float32) ** c)


def sgd(lr, momentum: float = 0.0, nesterov: bool = False) -> Optimizer:
    def init(params: Params) -> Dict:
        return {"mu": _f32_like(params) if momentum else None, "count": 0}

    def update(grads: Params, state: Dict, params: Params = None):
        step_lr = _resolve(lr, state["count"])
        g32 = {k: g.float() for k, g in grads.items()}
        if momentum:
            mu = {k: momentum * state["mu"][k] + g for k, g in g32.items()}
            eff = ({k: momentum * mu[k] + g for k, g in g32.items()}
                   if nesterov else mu)
        else:
            mu, eff = None, g32
        return ({k: -step_lr * g for k, g in eff.items()},
                {"mu": mu, "count": state["count"] + 1})
    return Optimizer(init, update)


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    def init(params: Params) -> Dict:
        return {"m": _f32_like(params), "v": _f32_like(params), "count": 0}

    def update(grads: Params, state: Dict, params: Params = None):
        c = state["count"] + 1
        step_lr = _resolve(lr, state["count"])
        bc1, bc2 = _f32_pow(b1, c), _f32_pow(b2, c)
        m, v, updates = {}, {}, {}
        for k, g in grads.items():
            g = g.float()
            m[k] = b1 * state["m"][k] + (1 - b1) * g
            v[k] = b2 * state["v"][k] + (1 - b2) * g.square()
            u = -step_lr * (m[k] / bc1) / ((v[k] / bc2).sqrt() + eps)
            if weight_decay:
                u = u - step_lr * weight_decay * params[k].float()
            updates[k] = u
        return updates, {"m": m, "v": v, "count": c}
    return Optimizer(init, update)


def yogi(lr, b1: float = 0.9, b2: float = 0.99, eps: float = 1e-3,
         v0: float = 1e-6) -> Optimizer:
    """Yogi: additive, sign-controlled second moment (FedYogi's server)."""
    def init(params: Params) -> Dict:
        return {"m": _f32_like(params),
                "v": {k: torch.full(p.shape, v0, dtype=torch.float32,
                                    device=p.device)
                      for k, p in params.items()},
                "count": 0}

    def update(grads: Params, state: Dict, params: Params = None):
        step_lr = _resolve(lr, state["count"])
        m, v, updates = {}, {}, {}
        for k, g in grads.items():
            g = g.float()
            g2 = g.square()
            m[k] = b1 * state["m"][k] + (1 - b1) * g
            v[k] = state["v"][k] - (1 - b2) * g2 \
                * torch.sign(state["v"][k] - g2)
            updates[k] = -step_lr * m[k] / (v[k].abs().sqrt() + eps)
        return updates, {"m": m, "v": v, "count": state["count"] + 1}
    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# schedules: step → learning rate, computed in f32 as the reference does
# ---------------------------------------------------------------------------


def _f32(step) -> torch.Tensor:
    return torch.tensor(float(step), dtype=torch.float32)


def cosine_schedule(peak_lr: float, total_steps: int,
                    warmup_steps: int = 0, floor: float = 0.0):
    def sched(step) -> float:
        s = _f32(step)
        warm = peak_lr * (s + 1) / max(warmup_steps, 1)
        prog = ((s - warmup_steps) / max(total_steps - warmup_steps, 1)) \
            .clamp(0.0, 1.0)
        cos = floor + (peak_lr - floor) * 0.5 * (1 + torch.cos(math.pi
                                                               * prog))
        return float(torch.where(s < warmup_steps, warm, cos))
    return sched


def linear_schedule(peak_lr: float, total_steps: int, warmup_steps: int = 0):
    def sched(step) -> float:
        s = _f32(step)
        warm = peak_lr * (s + 1) / max(warmup_steps, 1)
        lin = peak_lr * (1.0 - (s - warmup_steps)
                         / max(total_steps - warmup_steps, 1)).clamp(0.0, 1.0)
        return float(torch.where(s < warmup_steps, warm, lin))
    return sched
