"""Defenses for the one-shot round: validation, quarantine and retry (port
of ``repro/fl/resilience.py``).

FedPFT gets exactly one round, so a malformed message cannot be repaired
later: it is rejected with an explanation (so the byte ledger still
balances) and the round closes on whatever survived.  ``fl.faults`` is
the attack half; DESIGN.md §13 is the spec both are held to.

* :func:`validate_message`: the wire-level gate.  Header sanity, exact
  payload length against ``gmm.comm_bytes``, and finite decoded scalars
  (through the port's own ``fl.api.decode_payload``).  Returns a
  :class:`Rejection`, never raises.
* :class:`ResilienceConfig` + :func:`call_with_retry`: ``max_retries``
  extra attempts with deterministic exponential backoff measured on an
  injected clock (``advance``), never a real ``sleep``.
* :class:`TransientClientError`: what a client function (or
  ``fl.faults.flaky``) raises to mean "try again".
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.analysis.sanitize import reset_active
from repro_torch.core import gmm as G

__all__ = ["Rejection", "ResilienceConfig", "TransientClientError",
           "validate_message", "partition_valid", "call_with_retry",
           "backoff_schedule", "REJECT_REASONS"]

# the closed vocabulary of Rejection.reason — DESIGN.md §13's taxonomy
REJECT_REASONS = ("bad_header", "bad_counts", "length_mismatch",
                  "non_finite", "schema_mismatch")


class TransientClientError(RuntimeError):
    """A client attempt failed in a retryable way (network blip, preempted
    worker).  ``call_with_retry`` replays the attempt; any other exception
    type is permanent and propagates."""


@dataclasses.dataclass(frozen=True)
class Rejection:
    """One quarantined message: who, why, and how many bytes it carried
    (the broker adds them to ``quarantined_bytes``, so every byte the
    cohort sent lands in exactly one verdict class)."""
    client_id: int
    reason: str          # one of REJECT_REASONS
    detail: str
    comm_bytes: int

    def __post_init__(self):
        if self.reason not in REJECT_REASONS:
            raise ValueError(f"Rejection: reason {self.reason!r} not in "
                             f"{REJECT_REASONS}")


def _wire_itemsize(dtype: str) -> Optional[int]:
    if dtype == "bfloat16":
        return 2
    try:
        return np.dtype(dtype).itemsize
    except TypeError:
        return None


def validate_message(msg, n_classes: int, client_id: int = 0,
                     expect: Optional[Tuple[str, int, int]] = None
                     ) -> Optional[Rejection]:
    """Wire-level gate for one GMM message: None if clean, else why not.

    Checks, cheapest first: header schema, per-class counts, agreement
    with ``expect`` (the round's ``(cov_type, K, d)``), exact payload
    length against the present-class ``gmm.comm_bytes``, and finiteness
    of every decoded scalar.  Never raises.
    """
    h = msg.header
    b = msg.comm_bytes

    def rej(reason: str, detail: str) -> Rejection:
        return Rejection(client_id=int(client_id), reason=reason,
                         detail=detail, comm_bytes=int(b))

    if h.kind != "gmm":
        return rej("bad_header", f"kind={h.kind!r} — expected 'gmm'")
    if h.cov_type not in G.COV_TYPES:
        return rej("bad_header", f"cov_type={h.cov_type!r} not in "
                                 f"{G.COV_TYPES}")
    if h.K < 1 or h.d < 1:
        return rej("bad_header", f"K={h.K}, d={h.d} — need K≥1, d≥1")
    if h.n_classes != n_classes or len(h.counts) != h.n_classes:
        return rej("bad_header",
                   f"n_classes={h.n_classes} / len(counts)="
                   f"{len(h.counts)} ≠ round's C={n_classes}")
    if any(int(c) < 0 for c in h.counts):
        return rej("bad_counts", f"negative class count in {h.counts}")
    if expect is not None and (h.cov_type, h.K, h.d) != tuple(expect):
        return rej("schema_mismatch",
                   f"(cov={h.cov_type!r}, K={h.K}, d={h.d}) ≠ round "
                   f"schema (cov={expect[0]!r}, K={expect[1]}, "
                   f"d={expect[2]})")
    itemsize = _wire_itemsize(h.dtype)
    if itemsize is None:
        return rej("bad_header", f"unknown wire dtype {h.dtype!r}")
    n_present = len(h.present)
    want = G.comm_bytes(h.cov_type, h.d, h.K, n_present,
                        bytes_per_scalar=itemsize)
    if b != want:
        return rej("length_mismatch",
                   f"payload is {b} bytes, schema says {want} "
                   f"({n_present} present classes × "
                   f"{G.n_parameters(h.cov_type, h.d, h.K, 1)} params × "
                   f"{itemsize} B)")
    from repro_torch.fl import api as FA   # local: api imports this module
    params, err = FA.decode_payload(h, msg.payload)
    if err is not None:
        return rej("non_finite" if "finite" in err else "length_mismatch",
                   err)
    del params
    return None


def partition_valid(messages: Sequence, n_classes: int
                    ) -> Tuple[List, List[Rejection]]:
    """Split a message list into (clean, rejections); position is the
    client id, as in the Star round's enumeration."""
    ok: List = []
    rejs: List[Rejection] = []
    for i, m in enumerate(messages):
        r = validate_message(m, n_classes, client_id=i)
        if r is None:
            ok.append(m)
        else:
            rejs.append(r)
    return ok, rejs


# ---------------------------------------------------------------------------
# client-phase retry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """Session-level fault policy (``FedSession(resilience=...)``).

    ``max_retries`` extra attempts per client on
    :class:`TransientClientError`, backoff ``base · factor^attempt``
    seconds on an injected clock.  ``validate`` arms the wire gate on the
    host aggregate path (the streaming broker has its own
    ``IngestConfig.validate``).
    """
    max_retries: int = 2
    backoff_base_s: float = 0.5
    backoff_factor: float = 2.0
    validate: bool = True

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError(f"ResilienceConfig: max_retries="
                             f"{self.max_retries} must be ≥ 0")
        if self.backoff_base_s < 0 or self.backoff_factor < 1.0:
            raise ValueError(
                f"ResilienceConfig: backoff base={self.backoff_base_s}, "
                f"factor={self.backoff_factor} — need base ≥ 0, "
                "factor ≥ 1")


def backoff_schedule(cfg: ResilienceConfig, n: int) -> List[float]:
    """Delay before retry i (0-based): ``base · factor^i``."""
    return [cfg.backoff_base_s * cfg.backoff_factor ** i for i in range(n)]


def call_with_retry(fn: Callable[[], object], cfg: ResilienceConfig,
                    advance: Optional[Callable[[float], None]] = None):
    """Run ``fn`` with up to ``cfg.max_retries`` replays on transient
    failure.

    Returns ``(ok, result, attempts, backoff_s)``; ``ok=False`` means the
    client is lost (every attempt raised :class:`TransientClientError`).
    ``advance`` receives each backoff delay (a fake clock's hook); None
    discards them (they are still summed in ``backoff_s``).

    A replay must reproduce the message a clean first attempt would have
    sent: the caller's ``fn`` builds its client's draw stream afresh from
    the client's seed on every call.  The runtime stream tracer would flag
    exactly that replay, so it is announced before each one
    (``analysis.sanitize.reset_active`` — a documented suppression, not a
    bug; DESIGN.md §13).
    """
    backoff = 0.0
    for attempt in range(cfg.max_retries + 1):
        if attempt > 0:
            delay = cfg.backoff_base_s * cfg.backoff_factor ** (attempt - 1)
            backoff += delay
            if advance is not None:
                advance(delay)
            reset_active(f"client retry attempt {attempt}: deliberate "
                         "same-seed replay")
        try:
            return True, fn(), attempt + 1, backoff
        except TransientClientError:
            continue
    return False, None, cfg.max_retries + 1, backoff
