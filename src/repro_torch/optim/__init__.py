"""Adam, written by hand (port of ``repro/optim/__init__.py``).

``torch.optim.Adam`` is not used: the reference adds eps outside
``sqrt(v / bc2)`` and applies weight decay decoupled, as ``u − lr·wd·p``,
where ``torch.optim.Adam(weight_decay=)`` applies coupled L2.  Same
``(init, update)`` pair and ``apply_updates`` as the reference, over dicts
of tensors; optimizer state is f32 whatever the parameter dtype.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import torch

Params = Dict[str, torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def apply_updates(params: Params, updates: Params) -> Params:
    return {k: (p.float() + updates[k]).to(p.dtype) for k, p in params.items()}


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    def init(params: Params) -> Dict:
        zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for k, p in params.items()}
        return {"m": zeros, "v": {k: z.clone() for k, z in zeros.items()},
                "count": 0}

    def update(grads: Params, state: Dict, params: Params = None):
        c = state["count"] + 1
        one = torch.tensor(1.0, dtype=torch.float32)
        bc1 = float(one - torch.tensor(b1, dtype=torch.float32) ** c)
        bc2 = float(one - torch.tensor(b2, dtype=torch.float32) ** c)
        m, v, updates = {}, {}, {}
        for k, g in grads.items():
            g = g.float()
            m[k] = b1 * state["m"][k] + (1 - b1) * g
            v[k] = b2 * state["v"][k] + (1 - b2) * g.square()
            u = -lr * (m[k] / bc1) / ((v[k] / bc2).sqrt() + eps)
            if weight_decay:
                u = u - lr * weight_decay * params[k].float()
            updates[k] = u
        return updates, {"m": m, "v": v, "count": c}
    return Optimizer(init, update)
