"""The server phase as one **round program** of tensors and one static
signature (port of ``repro/fl/round.py``, DESIGN.md §11).

:func:`round_program` is the fused server phase, decode wire → slot grid →
``head.fused_gmm_steps``, as a plain function of tensors plus ONE
:class:`CohortSignature`: every shape it allocates is a function of the
signature, so ``launch.aot_cache`` can capture it once per canonical
signature as a CUDA graph and replay it for every matching cohort.

Two layouts, one program:

* ``layout="wire"``: the stacked wire tensors as encoded (``pi (M, C, K)``,
  ``mu (M, C, K, d)``, ``cov (M, C) + packed`` in the codec's dtype,
  ``counts (M, C)`` int32).  The cast to f32, the tril-unpack of full
  covariances and the slot grid happen inside the program.  The grid is
  the full M·C lattice, client-major, absent classes left in place at
  count 0: its shape is a function of the signature.
* ``layout="slots"``: an already-decoded flat slot stack (``pi (M, K)``,
  ``mu (M, K, d)``, ``cov (M, K, …)`` f32, ``slot_labels (M,)``,
  ``counts (M,)``): the streaming reservoir's ``IngestState.padded_stack``
  at ``M == capacity``.

Zero-count rows anywhere are exact no-ops under the fused trainer: the
slot draw is a ``searchsorted(right=True)`` over the f32 cumulative mass,
which never lands on a zero-mass row, so the full grid and the leading
``gmm.identity_gmm`` pad clients of :func:`pad_cohort` train heads
bit-identical to the compacted host path.  That rests on the cumulative
mass being exact: the counts are integer-valued f32, so every partial sum
is exact in any summation order (the card's parallel scan included) while
Σ counts < 2²⁴ = 16,777,216 draws.

bf16 goes through ``torch`` (round to nearest even, as ``ml_dtypes``),
so :data:`WIRE_DTYPES` maps codec names to torch dtypes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import gmm as G
from repro_torch.core import head as H

__all__ = [
    "CohortSignature", "WIRE_DTYPES", "next_pow2", "signature_of",
    "signature_of_state", "wire_stack", "pad_cohort", "pad_slots",
    "round_program",
]

# codec dtype name → torch dtype of the wire tensors (``fl.api``'s codec
# owns the byte layout; this module casts to and from it)
WIRE_DTYPES = {
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
}

LAYOUTS = ("wire", "slots")


def next_pow2(n: int) -> int:
    """Smallest power of two ≥ n (the planner's bucket law, n ≥ 1)."""
    if n < 1:
        raise ValueError(f"next_pow2: n={n} — cohorts have ≥ 1 client")
    return 1 << (int(n) - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class CohortSignature:
    """Everything the round program's shapes depend on.

    ``M`` is the client axis (``layout="wire"``) or the flat slot-row axis
    (``layout="slots"``); ``C``/``K``/``d``/``cov_type`` are the mixture
    schema; ``dtype`` is the codec dtype the wire tensors arrive in.
    Frozen and hashable: it is the program cache's key.
    """
    M: int
    C: int
    K: int
    d: int
    cov_type: str
    dtype: str = "bfloat16"
    layout: str = "wire"

    def __post_init__(self):
        if self.cov_type not in G.COV_TYPES:
            raise ValueError(f"CohortSignature: cov_type={self.cov_type!r} "
                             f"∉ {G.COV_TYPES}")
        if self.dtype not in WIRE_DTYPES:
            raise ValueError(f"CohortSignature: dtype={self.dtype!r} ∉ "
                             f"{tuple(WIRE_DTYPES)}")
        if self.layout not in LAYOUTS:
            raise ValueError(f"CohortSignature: layout={self.layout!r} ∉ "
                             f"{LAYOUTS}")
        if min(self.M, self.C, self.K, self.d) < 1:
            raise ValueError(f"CohortSignature: non-positive axis in "
                             f"(M={self.M}, C={self.C}, K={self.K}, "
                             f"d={self.d})")

    @property
    def n_slots(self) -> int:
        """Rows of the flat slot grid the head trains over."""
        return self.M * self.C if self.layout == "wire" else self.M

    def cov_shape(self, packed: bool) -> Tuple[int, ...]:
        """Trailing shape of one slot's cov leaf (packed = wire layout)."""
        if packed:
            return G.packed_cov_shape(self.cov_type, self.K, self.d)
        if self.cov_type == "full":
            return (self.K, self.d, self.d)
        return (self.K, self.d) if self.cov_type == "diag" else (self.K,)

    def canonical(self) -> "CohortSignature":
        """The signature a program is built for: M rounded up to a power
        of two.  C/K/d/cov_type/dtype stay exact: padding K would change
        the component draws and break bit-identity."""
        return dataclasses.replace(self, M=next_pow2(self.M))


def signature_of(messages: Sequence) -> CohortSignature:
    """The cohort signature of a homogeneous GMM message stack; raises
    ``ValueError`` on a heterogeneous cohort (mixed K / d / cov family /
    wire dtype, paper §6.3), which keeps the materializing path."""
    if not messages:
        raise ValueError("signature_of needs at least one message")
    sigs = {(m.header.kind, m.header.cov_type, m.header.K, m.header.d,
             m.header.n_classes, m.header.dtype) for m in messages}
    if len(sigs) > 1:
        raise ValueError(
            f"signature_of: heterogeneous cohort {sorted(sigs)} — mixed "
            "schemas can't share one round program")
    kind, cov_type, K, d, C, dtype = next(iter(sigs))
    if kind != "gmm":
        raise ValueError(f"signature_of: round programs train from GMM "
                         f"summaries, got kind={kind!r}")
    return CohortSignature(M=len(messages), C=C, K=K, d=d,
                           cov_type=cov_type, dtype=dtype, layout="wire")


def signature_of_state(state) -> CohortSignature:
    """Signature of an ``ingest.IngestState`` reservoir (decoded f32 slot
    rows at the fixed capacity)."""
    return CohortSignature(M=int(state.capacity), C=int(state.n_classes),
                           K=int(state.K), d=int(state.d),
                           cov_type=state.cov_type, dtype="float32",
                           layout="slots")


def _f32(t) -> torch.Tensor:
    return torch.as_tensor(t).detach().float()


def wire_stack(messages: Sequence
               ) -> Tuple[Dict[str, torch.Tensor], np.ndarray]:
    """Stack homogeneous messages into the round program's wire tensors:
    ``({"pi": (M, C, K), "mu": (M, C, K, d), "cov": (M, C) + packed} in
    the wire dtype, counts (M, C) int32)``, the tensors where the
    messages' parameters lie.  Values are the decoded f32 params cast
    back to the wire dtype: exact for present classes (they already
    round-tripped the codec); absent classes' placeholders may round, but
    their count-0 rows are never drawn.
    """
    sig = signature_of(messages)
    wd = WIRE_DTYPES[sig.dtype]
    pi = torch.stack([_f32(m.params["pi"]) for m in messages]).to(wd)
    mu = torch.stack([_f32(m.params["mu"]) for m in messages]).to(wd)
    cov = torch.stack([_f32(m.params["cov"]) for m in messages])
    if sig.cov_type == "full":
        cov = G.tril_pack(cov)
    cov = cov.to(wd)
    counts = np.stack([np.asarray(m.counts, np.int64)
                       for m in messages]).astype(np.int32)
    return {"pi": pi, "mu": mu, "cov": cov}, counts


def _pad_rows(sig: CohortSignature, n_pad: int, lead_shape: Tuple[int, ...],
              dtype: torch.dtype, device) -> Dict[str, torch.Tensor]:
    """``n_pad`` identity-GMM pad rows broadcast over ``lead_shape``."""
    ident = G.identity_gmm(sig.K, sig.d, sig.cov_type)
    cov = torch.from_numpy(ident["cov"])
    if sig.layout == "wire" and sig.cov_type == "full":
        cov = G.tril_pack(cov)
    out = {}
    for name, row in (("pi", torch.from_numpy(ident["pi"])),
                      ("mu", torch.from_numpy(ident["mu"])), ("cov", cov)):
        out[name] = row.to(device=device, dtype=dtype).expand(
            (n_pad,) + lead_shape + tuple(row.shape))
    return out


def pad_cohort(stack: Dict[str, torch.Tensor], counts: np.ndarray,
               sig: CohortSignature, target: CohortSignature
               ) -> Tuple[Dict[str, torch.Tensor], np.ndarray]:
    """Pad a wire-layout cohort up to the canonical signature: prepend
    ``target.M − sig.M`` identity-GMM clients with count 0 on every class
    — pads FIRST, as in the reservoir (DESIGN.md §9)."""
    if dataclasses.replace(sig, M=target.M) != target:
        raise ValueError(f"pad_cohort: {sig} only pads along M, target was "
                         f"{target}")
    if target.M < sig.M:
        raise ValueError(f"pad_cohort: target M={target.M} < cohort "
                         f"M={sig.M} — cohorts are padded up, never cut")
    n_pad = target.M - sig.M
    if n_pad == 0:
        return stack, counts
    dev = stack["mu"].device
    pad = _pad_rows(sig, n_pad, (sig.C,), WIRE_DTYPES[sig.dtype], dev)
    out = {k: torch.cat([pad[k], torch.as_tensor(v)]) for k, v in
           stack.items()}
    counts = np.concatenate([np.zeros((n_pad, sig.C), np.int32),
                             np.asarray(counts, np.int32)])
    return out, counts


def pad_slots(pi, mu, cov, slot_labels, counts, sig: CohortSignature,
              target: CohortSignature):
    """Slot-layout analogue of :func:`pad_cohort` (leading identity rows,
    label 0, count 0); takes and returns numpy arrays (the reservoir is
    host state)."""
    if dataclasses.replace(sig, M=target.M) != target:
        raise ValueError(f"pad_slots: {sig} only pads along M, target was "
                         f"{target}")
    if target.M < sig.M:
        raise ValueError(f"pad_slots: target M={target.M} < stack "
                         f"M={sig.M}")
    n_pad = target.M - sig.M
    if n_pad == 0:
        return pi, mu, cov, slot_labels, counts
    pad = {k: v.numpy() for k, v in _pad_rows(sig, n_pad, (), torch.float32,
                                             "cpu").items()}
    return (np.concatenate([pad["pi"], np.asarray(pi, np.float32)]),
            np.concatenate([pad["mu"], np.asarray(mu, np.float32)]),
            np.concatenate([pad["cov"], np.asarray(cov, np.float32)]),
            np.concatenate([np.zeros((n_pad,), np.int32),
                            np.asarray(slot_labels, np.int32)]),
            np.concatenate([np.zeros((n_pad,), np.int32),
                            np.asarray(counts, np.int32)]))


@torch.no_grad()
def round_program(pi, mu, cov, counts, slot_labels=None, *,
                  sig: CohortSignature, head_cfg: H.HeadConfig,
                  samples_per_class: Optional[int] = None,
                  generator: Optional[torch.Generator] = None,
                  draws: Optional[Dict[str, torch.Tensor]] = None):
    """The whole server phase as one function of tensors + statics; runs
    where ``mu`` lies.

    ``layout="wire"``: decode (cast → f32, tril-unpack), lay the full M·C
    slot grid out client-major (labels = slot index mod C), apply the
    ``samples_per_class`` override (absent classes stay 0), and run
    :func:`head.fused_gmm_steps`.  ``layout="slots"``: the inputs are the
    flat decoded stack (``slot_labels`` required; the reservoir applied
    ``samples_per_class`` at fold time, so pass None).  Every shape is a
    function of ``sig``, and nothing here waits on the device, so the
    program can be captured as a CUDA graph.  ``generator`` / ``draws`` as
    for ``fused_gmm_steps``.  Returns ``(head params, per-step losses)``.
    """
    C, K, d = sig.C, sig.K, sig.d
    dev = mu.device
    if sig.layout == "wire":
        n = sig.M * C
        pi32 = pi.float().reshape(n, K)
        mu32 = mu.float().reshape(n, K, d)
        cov32 = cov.float().reshape((n,) + sig.cov_shape(packed=True))
        if sig.cov_type == "full":
            cov32 = G.tril_unpack(cov32, d)
        labels = torch.arange(n, device=dev) % C
        n_eff = counts.reshape(n)
    else:
        if slot_labels is None:
            raise ValueError("round_program: layout='slots' needs "
                             "slot_labels")
        pi32, mu32, cov32 = pi.float(), mu.float(), cov.float()
        labels = slot_labels
        n_eff = counts
    if samples_per_class is not None:
        n_eff = torch.where(n_eff > 0, samples_per_class, 0)
    return H.fused_gmm_steps(pi32, mu32, cov32, labels, n_eff.int(), C,
                             head_cfg, sig.cov_type, generator=generator,
                             draws=draws)
