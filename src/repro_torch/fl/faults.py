"""Deterministic chaos injection for the one-shot round (port of
``repro/fl/faults.py``).

The attack half of DESIGN.md §13: a :class:`FaultPlan` is a seedable,
declarative description of what can go wrong between a client producing
its wire message and the broker folding it: drops, stragglers, payload
truncation, in-flight bit corruption, NaN poisoning, duplicate delivery
and reordering.  Every fate is a pure function of ``(plan.seed,
client_id, fault tag)`` through the splitmix64 hash the ingest reservoir
races on (host code, copied from the reference), so a chaos run is
reproducible: same plan + same cohort → same delivery schedule, byte for
byte.

:func:`schedule` turns ``[(client_id, message)]`` into time-ordered
:class:`Delivery` events for ``IngestBroker.submit`` under a fake clock;
:func:`flaky` wraps a client function to fail transiently after doing its
work.  The defenses live in ``fl.resilience`` and the broker.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.fl import api as FA
from repro_torch.fl.ingest import _splitmix64
from repro_torch.fl.resilience import TransientClientError

__all__ = ["FaultPlan", "Fate", "Delivery", "schedule", "flaky",
           "tamper_truncate", "tamper_corrupt", "tamper_poison"]


def _uniform(seed: int, client_id: int, tag: str) -> float:
    """Deterministic u ∈ (0, 1) from (seed, client, fault tag)."""
    mix = np.uint64(zlib.crc32(tag.encode()))
    x = np.asarray([np.uint64(seed)], np.uint64)
    with np.errstate(over="ignore"):
        h = _splitmix64(_splitmix64(x) ^ (np.uint64(client_id) + mix))
    return float(((h >> np.uint64(11)).astype(np.float64)[0] + 0.5)
                 * 2.0 ** -53)


@dataclasses.dataclass(frozen=True)
class Fate:
    """What the plan decided for one client (all deterministic)."""
    drop: bool
    straggle: bool
    tamper: Optional[str]       # None | "truncate" | "corrupt" | "poison"
    duplicate: bool
    transient_fails: int        # failed attempts before the message lands
    jitter_s: float             # reorder jitter added to the arrival time


@dataclasses.dataclass(frozen=True)
class Delivery:
    """One scheduled arrival at the broker."""
    t: float
    client_id: int
    message: object
    fault: Optional[str] = None   # provenance tag for logs and tests


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Per-client fault probabilities and magnitudes (one round).

    Tamper rates share one exclusive coin (cumulative thresholds), so they
    must sum to ≤ 1.  ``straggle_delay_s`` should exceed the broker's
    ``deadline_s`` to turn stragglers into ``late`` verdicts;
    ``reorder_jitter_s`` shuffles arrival order.
    """
    seed: int = 0
    drop: float = 0.0
    straggle: float = 0.0
    straggle_delay_s: float = 60.0
    truncate: float = 0.0
    corrupt: float = 0.0
    poison: float = 0.0
    duplicate: float = 0.0
    transient: float = 0.0
    transient_fails: int = 1
    reorder_jitter_s: float = 0.0
    arrival_spacing_s: float = 0.01

    def __post_init__(self):
        rates = {"drop": self.drop, "straggle": self.straggle,
                 "truncate": self.truncate, "corrupt": self.corrupt,
                 "poison": self.poison, "duplicate": self.duplicate,
                 "transient": self.transient}
        for name, p in rates.items():
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"FaultPlan: {name}={p} not in [0, 1]")
        if self.truncate + self.corrupt + self.poison > 1.0 + 1e-9:
            raise ValueError(
                f"FaultPlan: tamper rates sum to "
                f"{self.truncate + self.corrupt + self.poison} > 1 — they "
                "share one exclusive coin")
        if self.transient_fails < 0:
            raise ValueError(f"FaultPlan: transient_fails="
                             f"{self.transient_fails} must be ≥ 0")

    def fate(self, client_id: int) -> Fate:
        u_t = _uniform(self.seed, client_id, "tamper")
        if u_t < self.truncate:
            tamper = "truncate"
        elif u_t < self.truncate + self.corrupt:
            tamper = "corrupt"
        elif u_t < self.truncate + self.corrupt + self.poison:
            tamper = "poison"
        else:
            tamper = None
        coin = lambda tag, p: _uniform(self.seed, client_id, tag) < p
        return Fate(
            drop=coin("drop", self.drop),
            straggle=coin("straggle", self.straggle),
            tamper=tamper,
            duplicate=coin("duplicate", self.duplicate),
            transient_fails=(self.transient_fails
                             if coin("transient", self.transient) else 0),
            jitter_s=self.reorder_jitter_s
            * _uniform(self.seed, client_id, "jitter"))


# ---------------------------------------------------------------------------
# payload tampering
# ---------------------------------------------------------------------------


def _itemsize(dtype: str) -> int:
    return 2 if dtype in ("bfloat16", "float16") else 4


def tamper_truncate(msg, seed: int, client_id: int = 0):
    """Cut the payload short: the receiver's length check must fire.  The
    decoded ``params`` are left as they are: a validating receiver
    re-derives everything from the payload."""
    payload = msg.payload
    if len(payload) < 2:
        return msg
    cut = 1 + int(_uniform(seed, client_id, "cut")
                  * min(len(payload) - 1, 17))
    return dataclasses.replace(msg, payload=payload[:-cut])


def tamper_corrupt(msg, seed: int, client_id: int = 0):
    """Flip one scalar's bits to all-ones (NaN in every wire dtype): the
    receiver's finite check must fire.  ``params`` are re-derived from the
    corrupted payload, on the device the message's parameters lie on."""
    payload = bytearray(msg.payload)
    size = _itemsize(msg.header.dtype)
    if len(payload) < size:
        return msg
    n_scalars = len(payload) // size
    pos = int(_uniform(seed, client_id, "flip") * n_scalars) * size
    payload[pos:pos + size] = b"\xff" * size
    payload = bytes(payload)
    params, _ = FA.decode_payload(msg.header, payload)
    if params is not None:
        dev = msg.params["mu"].device
        params = {k: torch.from_numpy(v).to(dev) for k, v in params.items()}
    return dataclasses.replace(
        msg, payload=payload,
        params=msg.params if params is None else params)


def tamper_poison(msg, seed: int, client_id: int = 0):
    """NaN-poison the first present class's means and re-encode: the
    payload itself carries the poison, so the finite check fires on a
    faithful decode."""
    h = msg.header
    present = h.present
    if not present:
        return msg
    params = {k: torch.as_tensor(v).detach().float().clone()
              for k, v in msg.params.items()}
    params["mu"][present[0]] = float("nan")
    return FA.encode_message(params, np.asarray(h.counts, np.int64),
                             np.asarray(msg.logliks, np.float32),
                             kind="gmm", cov_type=h.cov_type,
                             n_classes=h.n_classes,
                             codec=FA.QuantizedCodec(h.dtype))


_TAMPER = {"truncate": tamper_truncate, "corrupt": tamper_corrupt,
           "poison": tamper_poison}


# ---------------------------------------------------------------------------
# the wire schedule
# ---------------------------------------------------------------------------


def schedule(plan: FaultPlan, items: Sequence[Tuple[int, object]],
             t0: float = 0.0) -> List[Delivery]:
    """Apply the plan to ``[(client_id, message)]`` → time-ordered
    deliveries.

    Client i's base arrival is ``t0 + i·arrival_spacing_s`` plus its
    reorder jitter; stragglers add ``straggle_delay_s``; duplicates
    arrive half a spacing after their original; dropped clients never
    appear.  Ties break on (t, client id, copy).
    """
    events: List[Delivery] = []
    for i, (cid, msg) in enumerate(items):
        fate = plan.fate(cid)
        if fate.drop:
            continue
        if fate.tamper is not None:
            msg = _TAMPER[fate.tamper](msg, plan.seed, cid)
        t = t0 + i * plan.arrival_spacing_s + fate.jitter_s
        if fate.straggle:
            t += plan.straggle_delay_s
        events.append(Delivery(t=t, client_id=cid, message=msg,
                               fault=fate.tamper))
        if fate.duplicate:
            events.append(Delivery(t=t + 0.5 * plan.arrival_spacing_s,
                                   client_id=cid, message=msg,
                                   fault="duplicate"))
    return sorted(events, key=lambda e: (e.t, e.client_id,
                                         e.fault == "duplicate"))


def flaky(fn: Callable, n_fails: int) -> Callable:
    """Wrap a client function to raise :class:`TransientClientError` on
    its first ``n_fails`` calls, AFTER running ``fn`` (a real client fails
    after doing its work), so the retry that follows replays a client
    whose draws were already made once."""
    def wrapper(*args, **kwargs):
        wrapper.calls += 1
        out = fn(*args, **kwargs)
        if wrapper.calls <= n_fails:
            raise TransientClientError(
                f"injected transient failure "
                f"{wrapper.calls}/{n_fails}")
        return out

    wrapper.calls = 0
    return wrapper
