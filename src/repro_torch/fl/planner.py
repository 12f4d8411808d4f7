"""Count-stratified synthesis planner (numpy copy of ``repro/fl/planner.py``).

The server draws ``n[m, c]`` samples from every (client, class) mixture
slot.  The planner groups the flat ``M·C`` slots into power-of-two count
buckets and builds the flat :class:`SlotTable` (ascending global slot id,
cumulative draw mass) that the fused head trainer
(``core.head.train_head_from_gmms``) draws slots from.  Pure host-side
bookkeeping, kept identical to the reference so both packages plan the
same slots.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

__all__ = ["Bucket", "SlotTable", "SynthesisPlan", "plan_synthesis"]

POLICIES = ("pow2", "single")


@dataclasses.dataclass(frozen=True, eq=False)
class Bucket:
    """One padded dispatch: ``len(slots)`` mixtures sampled at ``S`` each.

    ``eq=False``: the ndarray fields make the generated ``__eq__``/
    ``__hash__`` lies — identity comparison is the honest contract.
    """
    S: int                 # padded draw count for every slot in this bucket
    slots: np.ndarray      # (G_b,) flat slot ids into the (M·C) stack
    n_eff: np.ndarray      # (G_b,) requested samples per slot, 1 ≤ n ≤ S

    @property
    def padded_draws(self) -> int:
        return int(len(self.slots)) * self.S

    @property
    def requested(self) -> int:
        return int(self.n_eff.sum())


@dataclasses.dataclass(frozen=True, eq=False)
class SlotTable:
    """Flat per-slot draw table over every planned (nonzero) slot.

    Rows ascend by *global* slot id — bucket-independent — so the table is
    identical under every bucketing policy.  This is what the fused
    sampler-in-the-loop head trainer (``core.head.train_head_from_gmms``)
    keys on: ``cum_mass`` feeds the in-scan slot categorical
    (``gmm.draw_slots``) directly, no synthetic pool in between.
    """
    slots: np.ndarray      # (G,) global slot ids into the (M·C) stack
    counts: np.ndarray     # (G,) requested draws per slot, all ≥ 1
    cum_mass: np.ndarray   # (G,) f32 cumulative draw mass; last entry 1.0

    def __len__(self) -> int:
        return int(self.slots.shape[0])

    @classmethod
    def empty(cls) -> "SlotTable":
        """The merge identity: zero slots, zero mass."""
        z = np.zeros((0,), np.int64)
        return cls(slots=z, counts=z.copy(),
                   cum_mass=np.zeros((0,), np.float32))

    @classmethod
    def from_slots(cls, slots, counts) -> "SlotTable":
        """Build the canonical table from (slot id, draw count) pairs.

        Canonical means ascending global slot id with the cumulative mass
        recomputed from scratch — the same row a full-cohort
        ``plan_synthesis(...).slot_table`` would produce, so any fold
        order over chunks converges to the identical table.
        """
        slots = np.asarray(slots, np.int64).reshape(-1)
        counts = np.asarray(counts, np.int64).reshape(-1)
        if slots.shape != counts.shape:
            raise ValueError(
                f"SlotTable.from_slots: {slots.shape[0]} slot ids vs "
                f"{counts.shape[0]} counts — pass one count per slot id")
        if (counts <= 0).any():
            raise ValueError("SlotTable.from_slots: counts must be ≥ 1 — "
                             "drop zero-count slots before tabling them")
        if np.unique(slots).size != slots.size:
            raise ValueError("SlotTable.from_slots: duplicate slot ids — "
                             "use SlotTable.merge to sum overlapping tables")
        if slots.size == 0:
            return cls.empty()
        order = np.argsort(slots, kind="stable")
        slots, counts = slots[order], counts[order]
        cum = np.cumsum(counts.astype(np.float64))
        return cls(slots=slots, counts=counts,
                   cum_mass=(cum / cum[-1]).astype(np.float32))

    def merge(self, other: "SlotTable") -> "SlotTable":
        """Associative, commutative fold of two tables.

        Shared slot ids sum their counts (the same slot observed in two
        chunks), the union is re-canonicalized, so
        ``merge(a, merge(b, c)) == merge(merge(a, b), c)`` bitwise and
        ``SlotTable.empty()`` is the identity.
        """
        if len(self) == 0:
            return SlotTable.from_slots(other.slots, other.counts)
        if len(other) == 0:
            return SlotTable.from_slots(self.slots, self.counts)
        slots = np.concatenate([self.slots, other.slots])
        counts = np.concatenate([self.counts, other.counts])
        uniq, inv = np.unique(slots, return_inverse=True)
        summed = np.bincount(inv, weights=counts.astype(np.float64))
        return SlotTable.from_slots(uniq, summed.astype(np.int64))


@dataclasses.dataclass(frozen=True, eq=False)
class SynthesisPlan:
    """Bucketed schedule for one cohort's synthesis round.

    Buckets are ordered by ascending ``S`` and slots ascend within each
    bucket, so execution order — and the per-slot ``fold_in`` keys, which
    use *global* slot ids — is deterministic and independent of policy.
    (Keys, not realized values: a slot's draws depend on its bucket's
    padded S, so policies agree in distribution and per-slot counts,
    not bitwise.)
    """
    M: int
    C: int
    buckets: Tuple[Bucket, ...]

    @property
    def requested(self) -> int:
        """Σ n_eff — what Algorithm 1 actually asks for."""
        return sum(b.requested for b in self.buckets)

    @property
    def padded_draws(self) -> int:
        """What this plan will draw, padding included."""
        return sum(b.padded_draws for b in self.buckets)

    @property
    def monolithic_draws(self) -> int:
        """What the single-bucket (pre-planner) dispatch would draw:
        every slot padded to the global max count."""
        if not self.buckets:
            return 0
        return self.M * self.C * max(int(b.n_eff.max())
                                     for b in self.buckets)

    @property
    def n_dispatches(self) -> int:
        return len(self.buckets)

    @property
    def slot_table(self) -> SlotTable:
        """The plan's flat :class:`SlotTable` (global-slot-id order)."""
        if not self.buckets:
            return SlotTable.empty()
        return SlotTable.from_slots(
            np.concatenate([b.slots for b in self.buckets]),
            np.concatenate([b.n_eff for b in self.buckets]))


def _bucket_ceiling(n: np.ndarray) -> np.ndarray:
    """Next power of two ≥ n (n ≥ 1): the bucket's padded S."""
    return (2 ** np.ceil(np.log2(n)).astype(np.int64)).astype(np.int64)


def plan_synthesis(counts, samples_per_class: Optional[int] = None,
                   policy: str = "pow2") -> SynthesisPlan:
    """Build the bucketed schedule for a ``(M, C)`` counts matrix.

    ``samples_per_class`` overrides every present slot's count (absent
    slots stay 0), matching ``synthesize_batched``'s semantics.  The
    ``"pow2"`` policy guarantees ``padded_draws ≤ 2 · requested``;
    ``"single"`` is the old monolithic padded dispatch.
    """
    if policy not in POLICIES:
        raise ValueError(f"plan_synthesis: unknown policy {policy!r} — "
                         f"choose one of {POLICIES}")
    counts = np.asarray(counts, np.int64)
    if counts.ndim == 1:
        counts = counts[None]
    M, C = counts.shape
    n_eff = counts if samples_per_class is None else \
        np.where(counts > 0, samples_per_class, 0).astype(np.int64)
    flat = n_eff.reshape(-1)
    nz = np.flatnonzero(flat > 0)
    if nz.size == 0:
        return SynthesisPlan(M=M, C=C, buckets=())
    if policy == "single":
        S = int(flat[nz].max())
        return SynthesisPlan(M=M, C=C, buckets=(
            Bucket(S=S, slots=nz, n_eff=flat[nz]),))
    ceil = _bucket_ceiling(flat[nz])
    buckets = []
    for S in np.unique(ceil):
        sel = nz[ceil == S]
        buckets.append(Bucket(S=int(S), slots=sel, n_eff=flat[sel]))
    return SynthesisPlan(M=M, C=C, buckets=tuple(buckets))
