"""Streaming cohort ingestion: bounded server state over M clients (port of
``repro/fl/ingest.py``).

Arriving :class:`~repro_torch.fl.api.ClientMessage`\\ s fold into an
:class:`IngestState` of fixed capacity R, a chunk at a time, and the fused
head trainer runs on the resulting padded ``(R, K, …)`` slot stack, whose
shape is R whatever M, the chunk size or the number of retained slots.

* **Determinism**: a slot's retention priority is a pure function of its
  global slot id (``client·C + class``), its draw count and the seed
  (Efraimidis–Spirakis exponential race keyed by a splitmix64 hash), never
  of arrival order or RNG state, so ``merge`` is associative and
  commutative and :meth:`IngestState.empty` is its identity, bitwise.
* **Exactness under capacity**: while ``slots_seen ≤ capacity`` nothing is
  evicted, the retained table equals the full-cohort planner table, and
  the head is bit-identical to the non-streaming fused path (pads first:
  the f32 cumulative mass gains exact leading zeros).
* **Bounded memory**: resident bytes are the fixed-capacity state plus at
  most one pending chunk of decoded messages; :class:`IngestBroker`
  tracks the realized peak.

The state's arrays are numpy on the host, as in the reference: this is the
wire's receive side, and ``padded_stack()`` is what crosses to the device.
The splitmix64 hash and the race are host code copied from the reference,
so priorities are equal bit for bit.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import gmm as G
from repro_torch.fl import planner as P

__all__ = ["IngestConfig", "IngestState", "IngestBroker", "slot_priority",
           "fold_messages", "ADMITTED", "LATE", "DUPLICATE", "OVER_CAP",
           "QUARANTINED", "CLOSED", "VERDICTS"]

# broker verdicts — submit() returns one per message (DESIGN.md §13).
# Precedence when several apply: CLOSED > LATE > QUARANTINED > DUPLICATE >
# OVER_CAP — once the round is sealed nothing is inspected, and a corrupt
# copy must not consume its client's one admission slot.
ADMITTED = "admitted"
LATE = "late"              # arrived after the deadline, round still open
DUPLICATE = "duplicate"    # client id already admitted this round
OVER_CAP = "over_cap"      # admission policy: max_clients reached
QUARANTINED = "quarantined"  # failed the wire-level validation gate
CLOSED = "closed"          # arrived after close() sealed the round

VERDICTS = (ADMITTED, LATE, DUPLICATE, OVER_CAP, QUARANTINED, CLOSED)


@dataclasses.dataclass(frozen=True)
class IngestConfig:
    """Streaming-ingestion policy for one federation round.

    ``chunk_size`` pending messages fold into the state per step;
    ``capacity`` is R, the fixed number of mixture-slot rows the server
    retains.  ``max_clients`` caps admission; ``deadline_s`` closes the
    round this many seconds after the broker starts (later arrivals are
    counted as stragglers, never folded).  ``seed`` keys the retention
    priorities.  ``validate`` arms the wire-level quarantine gate
    (``resilience.validate_message``) on every submission.
    """
    chunk_size: int = 256
    capacity: int = 4096
    max_clients: Optional[int] = None
    deadline_s: Optional[float] = None
    seed: int = 0
    validate: bool = True

    def __post_init__(self):
        if self.chunk_size < 1:
            raise ValueError(f"IngestConfig: chunk_size={self.chunk_size} "
                             "— need ≥ 1 message per fold")
        if self.capacity < 1:
            raise ValueError(f"IngestConfig: capacity={self.capacity} — the "
                             "reservoir needs ≥ 1 slot row")


# ---------------------------------------------------------------------------
# deterministic retention priorities
# ---------------------------------------------------------------------------

_SM_GAMMA = np.uint64(0x9E3779B97F4A7C15)
_SM_M1 = np.uint64(0xBF58476D1CE4E5B9)
_SM_M2 = np.uint64(0x94D049BB133111EB)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer (uint64 → uint64, wrapping)."""
    with np.errstate(over="ignore"):
        x = x + _SM_GAMMA
        x = (x ^ (x >> np.uint64(30))) * _SM_M1
        x = (x ^ (x >> np.uint64(27))) * _SM_M2
        return x ^ (x >> np.uint64(31))


def slot_priority(slot_ids, counts, seed: int) -> np.ndarray:
    """Efraimidis–Spirakis retention key: ``log(u) / count`` with ``u``
    a deterministic hash of (seed, slot id) — NOT an RNG draw.

    Top-R by this key is a count-weighted sample without replacement, and
    because the key depends only on (seed, id, count), selection over any
    union of chunks is associative and arrival-order invariant.  Keys are
    strictly negative; larger (closer to 0) wins.
    """
    ids = np.asarray(slot_ids, np.uint64)
    h = _splitmix64(_splitmix64(np.full_like(ids, np.uint64(seed))) ^ ids)
    # 53 mantissa bits → u ∈ (0, 1) exactly representable, never 0 or 1
    u = ((h >> np.uint64(11)).astype(np.float64) + 0.5) * 2.0 ** -53
    return np.log(u) / np.asarray(counts, np.float64)


# ---------------------------------------------------------------------------
# mergeable bounded state
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class IngestState:
    """Fixed-capacity mergeable reservoir of mixture-slot rows.

    Canonical layout: all ``capacity`` rows exist, pad rows FIRST
    (``slot_ids == -1``, count 0, priority −inf, ``gmm.identity_gmm``
    parameters), then retained rows ascending by global slot id.  Pads
    first is what keeps the head bit-identical to the non-streaming fused
    path: the f32 cumulative mass gains exact leading zeros and the
    ``gmm.draw_slots`` clip lands on the last real row.
    """
    n_classes: int
    cov_type: str
    K: int
    d: int
    capacity: int
    seed: int
    slot_ids: np.ndarray   # (R,) int64, −1 on pads, else ascending ids
    priority: np.ndarray   # (R,) f64 retention keys, −inf on pads
    counts: np.ndarray     # (R,) int64 draw counts, 0 on pads
    pi: np.ndarray         # (R, K) f32
    mu: np.ndarray         # (R, K, d) f32
    cov: np.ndarray        # (R, K, …) f32 per cov family
    n_clients: int = 0     # clients folded in
    slots_seen: int = 0    # nonzero slots ever offered (retained + evicted)
    mass_seen: int = 0     # Σ draw counts ever offered

    @property
    def signature(self) -> Tuple:
        return (self.n_classes, self.cov_type, self.K, self.d,
                self.capacity, self.seed)

    @property
    def retained(self) -> int:
        return int((self.slot_ids >= 0).sum())

    @property
    def evicted(self) -> int:
        return self.slots_seen - self.retained

    @property
    def nbytes(self) -> int:
        """Resident bytes of the state arrays, independent of M."""
        return sum(a.nbytes for a in (self.slot_ids, self.priority,
                                      self.counts, self.pi, self.mu,
                                      self.cov))

    @classmethod
    def empty(cls, n_classes: int, cov_type: str, K: int, d: int,
              capacity: int, seed: int = 0) -> "IngestState":
        """The merge identity: all-pad state of the given signature."""
        pad = G.identity_gmm(K, d, cov_type)
        R = int(capacity)
        tile = lambda a: np.tile(a[None], (R,) + (1,) * a.ndim)
        return cls(n_classes=int(n_classes), cov_type=cov_type, K=int(K),
                   d=int(d), capacity=R, seed=int(seed),
                   slot_ids=np.full((R,), -1, np.int64),
                   priority=np.full((R,), -np.inf, np.float64),
                   counts=np.zeros((R,), np.int64),
                   pi=tile(pad["pi"]), mu=tile(pad["mu"]),
                   cov=tile(pad["cov"]))

    def _with_rows(self, ids, prio, counts, pi, mu, cov,
                   n_clients: int, slots_seen: int,
                   mass_seen: int) -> "IngestState":
        """Candidate rows (unique ids, any order) → canonical state:
        top-R by (priority desc, id asc), pads first, survivors ascending."""
        R = self.capacity
        if ids.shape[0] > R:
            # the exponential race: keep the R best keys, id-ascending
            # tie-break (hashes could collide)
            keep = np.lexsort((ids, -prio))[:R]
            ids, prio, counts = ids[keep], prio[keep], counts[keep]
            pi, mu, cov = pi[keep], mu[keep], cov[keep]
        order = np.argsort(ids, kind="stable")
        ids, prio, counts = ids[order], prio[order], counts[order]
        pi, mu, cov = pi[order], mu[order], cov[order]
        base = IngestState.empty(self.n_classes, self.cov_type, self.K,
                                 self.d, R, self.seed)
        n = ids.shape[0]
        out_ids, out_prio = base.slot_ids.copy(), base.priority.copy()
        out_counts = base.counts.copy()
        out_pi, out_mu, out_cov = (base.pi.copy(), base.mu.copy(),
                                   base.cov.copy())
        if n:
            out_ids[R - n:], out_prio[R - n:] = ids, prio
            out_counts[R - n:] = counts
            out_pi[R - n:], out_mu[R - n:], out_cov[R - n:] = pi, mu, cov
        return dataclasses.replace(
            self, slot_ids=out_ids, priority=out_prio, counts=out_counts,
            pi=out_pi, mu=out_mu, cov=out_cov, n_clients=n_clients,
            slots_seen=slots_seen, mass_seen=mass_seen)

    def merge(self, other: "IngestState") -> "IngestState":
        """Associative, commutative fold of two states (disjoint clients).

        The union of retained rows re-races for the R places on their
        deterministic priorities; shared slot ids dedupe to one row.
        Scalar accounting sums, so merge states built from disjoint
        submissions.
        """
        if self.signature != other.signature:
            raise ValueError(
                f"IngestState.merge: incompatible states — "
                f"{self.signature} vs {other.signature}; states must share "
                "(n_classes, cov_type, K, d, capacity, seed) to race for "
                "the same reservoir")
        va, vb = self.slot_ids >= 0, other.slot_ids >= 0
        ids = np.concatenate([self.slot_ids[va], other.slot_ids[vb]])
        prio = np.concatenate([self.priority[va], other.priority[vb]])
        counts = np.concatenate([self.counts[va], other.counts[vb]])
        pi = np.concatenate([self.pi[va], other.pi[vb]])
        mu = np.concatenate([self.mu[va], other.mu[vb]])
        cov = np.concatenate([self.cov[va], other.cov[vb]])
        _, first = np.unique(ids, return_index=True)
        if first.size != ids.size:
            keep = np.sort(first)
            ids, prio, counts = ids[keep], prio[keep], counts[keep]
            pi, mu, cov = pi[keep], mu[keep], cov[keep]
        return self._with_rows(
            ids, prio, counts, pi, mu, cov,
            n_clients=self.n_clients + other.n_clients,
            slots_seen=self.slots_seen + other.slots_seen,
            mass_seen=self.mass_seen + other.mass_seen)

    def slot_table(self) -> P.SlotTable:
        """Retained rows as the planner's canonical cumulative-mass table
        (under capacity: equal to the full-cohort plan's table)."""
        v = self.slot_ids >= 0
        if not v.any():
            return P.SlotTable.empty()
        return P.SlotTable.from_slots(self.slot_ids[v], self.counts[v])

    def padded_stack(self):
        """The fused head trainer's inputs at fixed shape (R, K, …):
        ``(pi, mu, cov, slot_labels, counts)``.  Pad labels are 0 but
        carry count 0, so they are never drawn."""
        labels = np.where(self.slot_ids >= 0,
                          self.slot_ids % self.n_classes, 0).astype(np.int32)
        return self.pi, self.mu, self.cov, labels, self.counts


def _host_f32(t) -> np.ndarray:
    return np.asarray(torch.as_tensor(t).detach().float().cpu(), np.float32)


def fold_messages(state: IngestState, items: Iterable[Tuple[int, object]],
                  samples_per_class: Optional[int] = None) -> IngestState:
    """Fold one chunk of ``(client_id, message)`` pairs into the state.

    Row extraction + the same top-R race as :meth:`IngestState.merge`, so
    folding in chunks of any size, in any arrival order, lands on the
    identical state.  The per-slot draw law matches ``plan_synthesis``:
    ``counts`` as they are, or ``samples_per_class`` for every present
    class.
    """
    C = state.n_classes
    ids_l: List[np.ndarray] = []
    cnt_l: List[np.ndarray] = []
    pi_l, mu_l, cov_l = [], [], []
    n_msgs = 0
    for client_id, msg in items:
        n_msgs += 1
        h = msg.header
        if h.kind != "gmm":
            raise ValueError(
                f"fold_messages: client {client_id} sent a {h.kind!r} "
                "message — streaming ingestion folds GMM summaries; head "
                "messages aggregate via FedSession(aggregate=...)")
        if (h.n_classes, h.cov_type, h.K, h.d) != (C, state.cov_type,
                                                   state.K, state.d):
            raise ValueError(
                f"fold_messages: client {client_id} schema "
                f"(C={h.n_classes}, cov={h.cov_type!r}, K={h.K}, d={h.d}) "
                f"≠ state schema (C={C}, cov={state.cov_type!r}, "
                f"K={state.K}, d={state.d}) — heterogeneous cohorts can't "
                "share one slot reservoir; run the host path with "
                "synthesis='pooled' (paper §6.3)")
        counts = msg.counts
        n_eff = counts if samples_per_class is None else \
            np.where(counts > 0, samples_per_class, 0).astype(np.int64)
        present = np.flatnonzero(n_eff > 0)
        if present.size == 0:
            continue
        ids_l.append(np.int64(client_id) * C + present)
        cnt_l.append(n_eff[present])
        rows = torch.as_tensor(present)
        params = {k: _host_f32(msg.params[k][rows.to(msg.params[k].device)])
                  for k in G.WIRE_FIELDS}
        pi_l.append(params["pi"])
        mu_l.append(params["mu"])
        cov_l.append(params["cov"])
    if not ids_l:
        return dataclasses.replace(state,
                                   n_clients=state.n_clients + n_msgs)
    ids = np.concatenate(ids_l)
    counts = np.concatenate(cnt_l)
    chunk = IngestState.empty(C, state.cov_type, state.K, state.d,
                              state.capacity, state.seed)._with_rows(
        ids, slot_priority(ids, counts, state.seed), counts,
        np.concatenate(pi_l), np.concatenate(mu_l), np.concatenate(cov_l),
        n_clients=n_msgs, slots_seen=int(ids.size),
        mass_seen=int(counts.sum()))
    return state.merge(chunk)


# ---------------------------------------------------------------------------
# the broker loop
# ---------------------------------------------------------------------------


class IngestBroker:
    """Callback-driven admission loop for one streaming round.

    ``submit(client_id, message)`` returns one of :data:`VERDICTS` and
    folds pending admissions into the :class:`IngestState` every
    ``chunk_size`` messages, so at most one chunk of decoded messages is
    resident beside the fixed-capacity state.  ``close()`` drains the
    remainder and seals the round (later submissions draw :data:`CLOSED`);
    the deadline, measured on the injectable ``clock`` (default
    ``time.monotonic``), seals admission implicitly (later arrivals draw
    :data:`LATE`).  Malformed or non-finite messages draw
    :data:`QUARANTINED` (``cfg.validate``; the first admitted message pins
    the round schema).  ``accounting()`` is the round's record:
    per-verdict counts and bytes (Σ per-verdict bytes == Σ submitted
    bytes), folds, reservoir occupancy and the realized peak resident
    bytes.
    """

    # kept Rejection records are capped; counts and bytes stay exact
    _MAX_REJECTIONS = 32

    def __init__(self, cfg: IngestConfig, n_classes: int,
                 samples_per_class: Optional[int] = None,
                 clock: Optional[Callable[[], float]] = None):
        self.cfg = cfg
        self.n_classes = int(n_classes)
        self.samples_per_class = samples_per_class
        self._clock = clock if clock is not None else time.monotonic
        self._t0 = self._clock()
        self._state: Optional[IngestState] = None
        self._pending: List[Tuple[int, object]] = []
        self._pending_bytes = 0
        self._admitted_ids: set = set()
        self._seen_ids: set = set()
        self._closed = False
        self._schema: Optional[Tuple[str, int, int]] = None  # (cov, K, d)
        #   pinned by the first admitted message
        self.header_d: Optional[int] = None   # last-seen feature dim, any
        #   verdict: lets an all-straggler round still size its init head
        self.admitted = 0
        self.late = 0
        self.duplicates = 0
        self.over_cap = 0
        self.quarantined = 0
        self.closed_rejects = 0
        self.admitted_bytes = 0
        self.late_bytes = 0
        self.duplicate_bytes = 0
        self.over_cap_bytes = 0
        self.quarantined_bytes = 0
        self.closed_bytes = 0
        self.sent_bytes = 0
        self.rejections: List = []       # first _MAX_REJECTIONS Rejections
        self.chunks_folded = 0
        self.peak_resident_bytes = 0

    def _resident_bytes(self) -> int:
        return (self._state.nbytes if self._state is not None else 0) \
            + self._pending_bytes

    def _track_peak(self) -> None:
        self.peak_resident_bytes = max(self.peak_resident_bytes,
                                       self._resident_bytes())

    @staticmethod
    def _message_bytes(msg) -> int:
        """Resident cost of one pending message: wire payload + its decoded
        f32 arrays."""
        dec = sum(int(torch.as_tensor(v).numel())
                  * torch.as_tensor(v).element_size()
                  for v in msg.params.values())
        return msg.comm_bytes + dec

    def _past_deadline(self) -> bool:
        return self.cfg.deadline_s is not None and \
            (self._clock() - self._t0) > self.cfg.deadline_s

    @property
    def closed(self) -> bool:
        return self._closed

    def time_remaining(self) -> Optional[float]:
        """Seconds until the deadline (None without one; 0.0 once passed
        or closed)."""
        if self.cfg.deadline_s is None:
            return None
        if self._closed:
            return 0.0
        return max(0.0, self.cfg.deadline_s - (self._clock() - self._t0))

    def _fold(self) -> None:
        if not self._pending:
            return
        if self._state is None:
            h = self._pending[0][1].header
            self._state = IngestState.empty(
                self.n_classes, h.cov_type, h.K, h.d,
                self.cfg.capacity, self.cfg.seed)
            self._track_peak()   # state arrays + full pending chunk coexist
        self._state = fold_messages(self._state, self._pending,
                                    self.samples_per_class)
        self._pending = []
        self._pending_bytes = 0
        self.chunks_folded += 1
        self._track_peak()

    def submit(self, client_id: int, message) -> str:
        """Offer one client's message; returns the admission verdict.

        Every submission's bytes land in exactly one verdict bucket;
        precedence CLOSED > LATE > QUARANTINED > DUPLICATE > OVER_CAP.
        """
        if message.header.kind != "gmm":
            raise ValueError(
                f"IngestBroker: client {client_id} sent a "
                f"{message.header.kind!r} message — streaming ingestion "
                "folds GMM summaries; head messages aggregate via "
                "FedSession(aggregate=...)")
        self.header_d = int(message.header.d)
        self._seen_ids.add(client_id)
        nbytes = message.comm_bytes
        self.sent_bytes += nbytes
        if self._closed:
            self.closed_rejects += 1
            self.closed_bytes += nbytes
            return CLOSED
        if self._past_deadline():
            self.late += 1
            self.late_bytes += nbytes
            return LATE
        if self.cfg.validate:
            from repro_torch.fl import resilience as RS
            rej = RS.validate_message(message, self.n_classes,
                                      client_id=client_id,
                                      expect=self._schema)
            if rej is not None:
                self.quarantined += 1
                self.quarantined_bytes += nbytes
                if len(self.rejections) < self._MAX_REJECTIONS:
                    self.rejections.append(rej)
                return QUARANTINED
        if client_id in self._admitted_ids:
            self.duplicates += 1
            self.duplicate_bytes += nbytes
            return DUPLICATE
        if self.cfg.max_clients is not None and \
                self.admitted >= self.cfg.max_clients:
            self.over_cap += 1
            self.over_cap_bytes += nbytes
            return OVER_CAP
        self._admitted_ids.add(client_id)
        if self._schema is None:
            h = message.header
            self._schema = (h.cov_type, int(h.K), int(h.d))
        self.admitted += 1
        self.admitted_bytes += nbytes
        self._pending.append((client_id, message))
        self._pending_bytes += self._message_bytes(message)
        self._track_peak()
        if len(self._pending) >= self.cfg.chunk_size:
            self._fold()
        return ADMITTED

    def close(self) -> Optional[IngestState]:
        """Seal the round: fold the remainder, reject later submissions.
        Returns the final state, or None if nothing was admitted."""
        self._fold()
        self._closed = True
        return self._state

    @property
    def admitted_ids(self) -> Tuple[int, ...]:
        """Admitted client ids, ascending: the surviving cohort a
        partial-round bit-identity check replays offline."""
        return tuple(sorted(self._admitted_ids))

    def accounting(self) -> Dict:
        s = self._state
        return {
            "admitted": self.admitted,
            "late": self.late,
            "duplicates": self.duplicates,
            "over_cap": self.over_cap,
            "quarantined": self.quarantined,
            "closed": self.closed_rejects,
            "admitted_bytes": self.admitted_bytes,
            "late_bytes": self.late_bytes,
            "duplicate_bytes": self.duplicate_bytes,
            "over_cap_bytes": self.over_cap_bytes,
            "quarantined_bytes": self.quarantined_bytes,
            "closed_bytes": self.closed_bytes,
            "sent_bytes": self.sent_bytes,
            "clients_seen": len(self._seen_ids),
            "chunks_folded": self.chunks_folded,
            "chunk_size": self.cfg.chunk_size,
            "capacity": self.cfg.capacity,
            "slots_seen": 0 if s is None else s.slots_seen,
            "slots_retained": 0 if s is None else s.retained,
            "slots_evicted": 0 if s is None else s.evicted,
            "mass_seen": 0 if s is None else s.mass_seen,
            "peak_resident_bytes": self.peak_resident_bytes,
        }
