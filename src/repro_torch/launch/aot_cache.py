"""Round-program cache: one captured CUDA graph per canonical cohort
signature (port of ``repro/launch/aot_cache.py``, DESIGN.md §11).

The reference lowers and compiles ``fl.round.round_program`` ahead of
time per canonical signature and serves every matching cohort from the
executable.  The port's counterpart of that executable is a
``torch.cuda.CUDAGraph``: the whole server phase (decode → slot grid →
every Adam step of ``head.fused_gmm_steps``) captured once over static
input buffers allocated from ``launch.input_specs.round_specs_for``, then
replayed.  A replay launches the captured kernels with no Python in
between, where the eager server runs one Python Adam step at a time.

* Cohorts are **canonicalized**: M rounds up to a power of two and the
  session pads with ``gmm.identity_gmm`` count-0 clients, so the cache
  holds the small canonical grid, not every cohort size.
* Entries live in an **LRU** keyed on (canonical signature, head config,
  ``samples_per_class``, device); the mesh fingerprint of the reference
  waits for ROADMAP item 9.  It is bounded by ``max_entries`` and by
  ``max_bytes``, the device memory its entries hold together: a new
  entry evicts the least recently used ones until both bounds hold (the
  newest entry always stays).  Eviction drops the graph, its static
  buffers and its private memory pool.
* **Memory.**  An entry holds its static inputs and the graph's private
  pool, which keeps the step loop's working set for as long as the
  entry lives (an eager round frees it when it returns).  The pool grows
  as ``noise_window · batch_size · d``, about six f32 blocks of that
  size, and hardly with M: 260 MB an entry at d = 1280, batch 256,
  window 32 (``chip_smoke.py``'s ``program_cache`` phase, NVIDIA H100
  80GB HBM3 at 700 W).  The default ``max_bytes`` of 4 GiB holds the
  default ``canonical_grid`` (nine entries) at that width.
* **Draws** come from the device's default CUDA generator, which
  ``torch.cuda.graph`` registers with every capture.  Before a replay the
  caller's generator state is copied into it and afterwards copied back
  (and the default generator restored), so a replay makes exactly the
  draws an eager ``round_program`` call on the caller's generator makes
  and leaves the generator where the eager call would.
* **Outputs** of a replay live in the graph's static buffers; a call
  returns clones, so the next replay cannot overwrite a head already
  returned.

Counters keep the reference's names, so code reading ``stats()`` or
``info["compile"]`` reads both packages: ``compiles`` counts captures and
``compile_us`` / ``total_compile_us`` their time (a warm-up call, the
capture and a synchronize), ``aot`` in ``info["compile"]`` says the entry
replays a graph.  ``jit_fallbacks`` counts entries that run eagerly on
``cuda`` because their capture failed.  A full-covariance program groups
its draws by data-dependent sizes and is never captured: its entry runs
eagerly by design and moves no counter but ``misses``.  On the CPU an
entry is the eager function (there is no capture there), and neither
``compiles`` nor ``jit_fallbacks`` moves.  The reference's
executable serialization and HLO cost have no graph counterpart.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.fl import round as FR
from repro_torch.launch import input_specs as IS

__all__ = ["CachedProgram", "ProgramCache", "canonical_grid",
           "serving_grid"]


def _identity_inputs(sig: FR.CohortSignature, device: torch.device):
    """Static input buffers allocated from ``round_specs_for(sig)``, filled
    with count-0 identity mixtures (valid inputs for the warm-up call)."""
    specs = IS.round_specs_for(sig)
    lead = (sig.C,) if sig.layout == "wire" else ()
    pads = FR._pad_rows(sig, sig.M, lead, specs[0][1], device)
    bufs = []
    for spec, fill in zip(specs, (pads["pi"], pads["mu"], pads["cov"], 0,
                                  0)):
        if spec is None:
            bufs.append(None)
            continue
        buf = torch.empty(spec[0], dtype=spec[1], device=device)
        bufs.append(buf.copy_(fill) if torch.is_tensor(fill)
                    else buf.fill_(fill))
    return tuple(bufs)


def _default_generator(device: torch.device) -> torch.Generator:
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return torch.cuda.default_generators[index]


@dataclasses.dataclass(eq=False)
class CachedProgram:
    """One cache entry: the captured round program and its provenance.

    ``graph`` is None on the CPU and for an entry that runs eagerly on
    ``cuda`` (``eager_reason`` says why: full covariance, or a failed
    capture).  ``memory_bytes`` is what the entry holds on
    the device: its static inputs plus the graph's private memory pool
    (``torch.cuda.memory_reserved`` after the capture minus just before
    it, the cache emptied; library workspaces the warm-up call created
    are not the entry's).
    """
    sig: FR.CohortSignature
    head_cfg: Any
    samples_per_class: Optional[int]
    device: torch.device
    graph: Any = None
    inputs: Tuple = ()
    outputs: Any = None
    compile_us: float = 0.0
    memory_bytes: int = 0
    eager_reason: Optional[str] = None
    uses: int = 0

    @property
    def aot(self) -> bool:
        return self.graph is not None

    def _eager(self, args, generator):
        args = [None if a is None else torch.as_tensor(a).to(self.device)
                for a in args]
        return FR.round_program(*args, sig=self.sig, head_cfg=self.head_cfg,
                                samples_per_class=self.samples_per_class,
                                generator=generator)

    def __call__(self, pi, mu, cov, counts, slot_labels=None, *,
                 generator: torch.Generator):
        """``round_program`` on these inputs, its draws from
        ``generator``: ``(head params, per-step losses)``."""
        args = (pi, mu, cov, counts, slot_labels)
        if self.graph is None:
            return self._eager(args, generator)
        for buf, a in zip(self.inputs, args):
            if buf is not None:
                buf.copy_(torch.as_tensor(a))
        default = _default_generator(self.device)
        saved = default.get_state()
        default.set_state(generator.get_state())
        self.graph.replay()
        generator.set_state(default.get_state())
        default.set_state(saved)
        head, losses = self.outputs
        return {k: v.clone() for k, v in head.items()}, losses.clone()


def _capture(entry: CachedProgram, side: "torch.cuda.Stream") -> None:
    """Capture ``entry``'s round program as a CUDA graph, in place, on the
    cache's side stream (one per device, so the library workspaces that
    the warm-up call creates for it are made once, not per entry)."""
    dev = entry.device
    inputs = _identity_inputs(entry.sig, dev)

    def program():
        return FR.round_program(*inputs, sig=entry.sig,
                                head_cfg=entry.head_cfg,
                                samples_per_class=entry.samples_per_class)

    default = _default_generator(dev)
    saved = default.get_state()
    try:
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            program()          # warm-up: library handles, autograd engine
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        r0 = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            outputs = program()
        torch.cuda.synchronize(dev)
    finally:
        default.set_state(saved)
    entry.graph, entry.inputs, entry.outputs = graph, inputs, outputs
    entry.memory_bytes = torch.cuda.memory_reserved(dev) - r0 + sum(
        t.numel() * t.element_size() for t in inputs if t is not None)


class ProgramCache:
    """LRU of round programs keyed on canonical signatures.

    One instance serves every ``FedSession`` path that trains the fused
    head (the host Star round and streaming ingest), so a server captures
    each canonical (signature, head config, device) once.  Not
    thread-safe: the session loop is single-threaded.
    """

    def __init__(self, max_entries: int = 32, max_bytes: int = 4 << 30):
        if max_entries < 1:
            raise ValueError(f"ProgramCache: max_entries={max_entries}")
        if max_bytes < 0:
            raise ValueError(f"ProgramCache: max_bytes={max_bytes}")
        self.max_entries = int(max_entries)
        self.max_bytes = int(max_bytes)
        self._entries: "collections.OrderedDict[Tuple, CachedProgram]" = \
            collections.OrderedDict()
        self._side: Dict[str, "torch.cuda.Stream"] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.compiles = 0
        self.jit_fallbacks = 0
        self.total_compile_us = 0.0

    @staticmethod
    def _key(canon, head_cfg, samples_per_class, device) -> Tuple:
        return (canon, head_cfg, samples_per_class, str(device))

    def get(self, sig: FR.CohortSignature, head_cfg,
            samples_per_class: Optional[int] = None,
            device=None) -> CachedProgram:
        """The program for ``sig``'s canonical form on ``device`` (``cuda``
        unless ``device="cpu"``), captured on first use."""
        dev = resolve_device(device)
        canon = sig.canonical()
        ck = self._key(canon, head_cfg, samples_per_class, dev)
        entry = self._entries.get(ck)
        if entry is not None:
            self.hits += 1
            self._entries.move_to_end(ck)
            entry.uses += 1
            return entry
        self.misses += 1
        entry = self._build(canon, head_cfg, samples_per_class, dev)
        entry.uses = 1
        self._entries[ck] = entry
        while len(self._entries) > 1 and (
                len(self._entries) > self.max_entries
                or self.memory_bytes > self.max_bytes):
            self._entries.popitem(last=False)
            self.evictions += 1
        return entry

    def _build(self, canon, head_cfg, samples_per_class,
               dev: torch.device) -> CachedProgram:
        entry = CachedProgram(sig=canon, head_cfg=head_cfg,
                              samples_per_class=samples_per_class,
                              device=dev)
        if dev.type != "cuda":
            return entry
        if canon.cov_type == "full":
            entry.eager_reason = ("full covariance groups its draws by "
                                  "data-dependent sizes: not captured")
            return entry
        side = self._side.setdefault(str(dev), torch.cuda.Stream(dev))
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        try:
            _capture(entry, side)
        except RuntimeError as e:
            entry.graph, entry.inputs, entry.outputs = None, (), None
            entry.eager_reason = f"capture failed: {e}"
            self.jit_fallbacks += 1
            return entry
        entry.compile_us = (time.perf_counter() - t0) * 1e6
        self.compiles += 1
        self.total_compile_us += entry.compile_us
        return entry

    def warmup(self, sigs: Sequence[FR.CohortSignature], head_cfg,
               samples_per_class: Optional[int] = None,
               device=None) -> Dict[str, Any]:
        """Build a signature list before serving; returns :meth:`stats`."""
        for sig in sigs:
            self.get(sig, head_cfg, samples_per_class, device=device)
        return self.stats()

    def __len__(self) -> int:
        return len(self._entries)

    def keys(self) -> List[Tuple]:
        """Cache keys in LRU order (oldest first): the eviction order."""
        return list(self._entries)

    def entries(self) -> List[CachedProgram]:
        """The cached programs in LRU order."""
        return list(self._entries.values())

    @property
    def memory_bytes(self) -> int:
        """Device memory the entries hold together (their
        ``memory_bytes``; 0 on the CPU)."""
        return sum(e.memory_bytes for e in self._entries.values())

    def stats(self) -> Dict[str, Any]:
        return {"entries": len(self._entries), "hits": self.hits,
                "misses": self.misses, "evictions": self.evictions,
                "compiles": self.compiles,
                "jit_fallbacks": self.jit_fallbacks,
                "total_compile_us": self.total_compile_us}

    def snapshot(self) -> Dict[str, Any]:
        """``stats()`` frozen for a later :meth:`delta`:
        ``delta(before)["compiles"] == 0`` after a warm-up proves a round
        reused a warm program."""
        return self.stats()

    def delta(self, before: Dict[str, Any]) -> Dict[str, Any]:
        """Counter movement since ``before`` (a :meth:`snapshot`)."""
        now = self.stats()
        return {k: now[k] - before.get(k, 0) for k in now}


def canonical_grid(C: int, d: int, Ms: Sequence[int] = (4, 16, 64),
                   Ks: Sequence[int] = (1, 2, 4),
                   cov_types: Sequence[str] = ("diag",),
                   dtypes: Sequence[str] = ("bfloat16",),
                   layout: str = "wire") -> List[FR.CohortSignature]:
    """A small canonical signature grid to warm the cache with (Ms must
    be powers of two: this names the targets, it does not bucket)."""
    for m in Ms:
        if FR.next_pow2(m) != m:
            raise ValueError(f"canonical_grid: M={m} is not a power of two "
                             "— the grid names canonical shapes")
    return [FR.CohortSignature(M=m, C=C, K=k, d=d, cov_type=cov,
                               dtype=dt, layout=layout)
            for m in Ms for k in Ks for cov in cov_types for dt in dtypes]


def serving_grid(capacity: int, C: int, K: int, d: int,
                 cov_types: Sequence[str] = ("diag",)
                 ) -> List[FR.CohortSignature]:
    """The signatures a streaming-ingest server requests: the reservoir
    closes at its fixed ``capacity`` in the f32 ``"slots"`` layout, so one
    canonical signature per covariance type.  Warm them with the session's
    head config and ``samples_per_class=None``:
    ``cache.warmup(serving_grid(...), session.head)``."""
    M = FR.next_pow2(capacity)
    return [FR.CohortSignature(M=M, C=C, K=K, d=d, cov_type=cov,
                               dtype="float32", layout="slots")
            for cov in cov_types]
