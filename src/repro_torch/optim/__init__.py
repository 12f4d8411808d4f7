"""Optimizers, written by hand (port of ``repro/optim/__init__.py``).

Each optimizer is an ``(init, update)`` pair over trees of tensors (nested
dicts, as the reference's ``jax.tree.map`` walks them; flat dicts are one
level of them), with ``apply_updates`` as in the reference, and
``update_``, the same step in place (what the training step takes on the
card, where a second copy of the state would not fit); optimizer state is
f32 whatever the parameter dtype.  ``torch.optim`` is not used: the
reference adds eps outside ``sqrt(v / bc2)`` and applies weight decay
decoupled, as
``u − lr·wd·p``, where ``torch.optim.Adam(weight_decay=)`` applies coupled
L2.  Provided: sgd (momentum, Nesterov), adam, yogi (FedYogi's server
optimizer) and the cosine / linear-warmup schedules; a learning rate may
be a schedule, called with the step count before the update.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, NamedTuple, Tuple

import torch

Params = Dict[str, Any]
# a step's update of one leaf: (grad, param or None, *slot leaves) →
# (update f32, new slot leaves)
LeafRule = Callable[..., Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]]
# elements per piece of an in-place step: bounds its f32 temporaries
PIECE = 1 << 25


class Optimizer(NamedTuple):
    """``update(grads, state, params)`` → (updates, new state), pure, as
    the reference's; ``update_(grads, state, params)`` takes the same step
    in place: each parameter and state leaf is overwritten by its stepped
    value (bitwise ``apply_updates(params, update(...)[0])`` and the new
    state), piece by piece, so neither a second copy of the state nor a
    tree of updates is ever held.  It returns the state, count advanced."""
    init: Callable
    update: Callable
    update_: Callable


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of nested dicts (``jax.tree.map``'s walk
    over the port's parameter and state trees); ``rest`` share ``tree``'s
    structure.  None is a leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of nested dicts in insertion order (None skipped)."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [] if tree is None else [tree]


def apply_updates(params: Params, updates: Params) -> Params:
    return tree_map(lambda p, u: (p.float() + u).to(p.dtype), params,
                    updates)


def _f32_like(params: Params, fill: float = 0.0) -> Params:
    return tree_map(lambda p: torch.full(p.shape, fill, dtype=torch.float32,
                                         device=p.device), params)


def _resolve(lr, count: int) -> float:
    return float(lr(count)) if callable(lr) else lr


def _f32_pow(base: float, c: int) -> float:
    """``1 − base**c`` in f32, as the reference computes bias corrections."""
    one = torch.tensor(1.0, dtype=torch.float32)
    return float(one - torch.tensor(base, dtype=torch.float32) ** c)


def _pieces(*tensors: torch.Tensor):
    """Matching flat pieces of at most ``PIECE`` elements of same-sized
    tensors: views of the contiguous ones (the targets of an in-place
    step; a strided target raises), a copy of a strided gradient."""
    flat = [t.view(-1) if t.is_contiguous() else t.reshape(-1)
            for t in tensors]
    n = flat[0].numel()
    for i in range(0, n, PIECE):
        yield [f[i:i + PIECE] for f in flat]


def _optimizer(init: Callable, rule: Callable[[int], LeafRule],
               slots: Tuple[str, ...]) -> Optimizer:
    """An optimizer from its per-leaf rule: ``rule(count)`` gives the
    step's ``LeafRule`` over the state trees named in ``slots``."""
    def update(grads: Params, state: Dict, params: Params = None):
        leaf = rule(state["count"])
        ps = params if params is not None else tree_map(lambda g: None,
                                                        grads)
        out = tree_map(leaf, grads, ps, *(state[n] for n in slots))
        new = dict(state, count=state["count"] + 1)
        for i, name in enumerate(slots):
            new[name] = tree_map(lambda o, i=i: o[1][i], out)
        return tree_map(lambda o: o[0], out), new

    def update_(grads: Params, state: Dict, params: Params) -> Dict:
        leaf = rule(state["count"])

        def one(g, p, *slot):
            for gp, pp, *sp in _pieces(g, p, *slot):
                u, new = leaf(gp, pp, *sp)
                for old, nw in zip(sp, new):
                    old.copy_(nw)
                pp.copy_((pp.float() + u).to(pp.dtype))
        tree_map(one, grads, params, *(state[n] for n in slots))
        state["count"] += 1
        return state
    return Optimizer(init, update, update_)


def sgd(lr, momentum: float = 0.0, nesterov: bool = False) -> Optimizer:
    def init(params: Params) -> Dict:
        return {"mu": _f32_like(params) if momentum else None, "count": 0}

    def rule(count: int) -> LeafRule:
        step_lr = _resolve(lr, count)

        def leaf(g, p, *mu):
            g = g.float()
            if not momentum:
                return -step_lr * g, ()
            m = momentum * mu[0] + g
            eff = momentum * m + g if nesterov else m
            return -step_lr * eff, (m,)
        return leaf
    return _optimizer(init, rule, ("mu",) if momentum else ())


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    def init(params: Params) -> Dict:
        return {"m": _f32_like(params), "v": _f32_like(params), "count": 0}

    def rule(count: int) -> LeafRule:
        c = count + 1
        step_lr = _resolve(lr, count)
        bc1, bc2 = _f32_pow(b1, c), _f32_pow(b2, c)

        def leaf(g, p, m, v):
            g = g.float()
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g.square()
            u = -step_lr * (m / bc1) / ((v / bc2).sqrt() + eps)
            if weight_decay:
                u = u - step_lr * weight_decay * p.float()
            return u, (m, v)
        return leaf
    return _optimizer(init, rule, ("m", "v"))


def yogi(lr, b1: float = 0.9, b2: float = 0.99, eps: float = 1e-3,
         v0: float = 1e-6) -> Optimizer:
    """Yogi: additive, sign-controlled second moment (FedYogi's server)."""
    def init(params: Params) -> Dict:
        return {"m": _f32_like(params), "v": _f32_like(params, v0),
                "count": 0}

    def rule(count: int) -> LeafRule:
        step_lr = _resolve(lr, count)

        def leaf(g, p, m, v):
            g = g.float()
            g2 = g.square()
            m = b1 * m + (1 - b1) * g
            v = v - (1 - b2) * g2 * torch.sign(v - g2)
            return -step_lr * m / (v.abs().sqrt() + eps), (m, v)
        return leaf
    return _optimizer(init, rule, ("m", "v"))


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
