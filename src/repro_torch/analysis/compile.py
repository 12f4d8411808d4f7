"""CHURN-RETRACE and CACHE-KEY: every registered entry point runs the
same ATen op sequence for the same shapes, across its canonical grid
(port of ``repro/analysis/compile.py``).

The reference traces its jitted entry points to jaxprs.  The port has no
tracer; its counterpart of a trace is a run on ``meta`` tensors (shapes
only, where every kernel wrapper takes its plain version) under a
dispatch recorder (``launch.hlo_cost.OpTrace``), which lists each ATen op
with its output shapes.  The registry below holds the port's
counterparts of the reference's six entries — the fused E-step,
attention, ``train_head``, the batched GMM fit, ``local_train`` and
``_sample_stacked`` — and the round program that
``launch.aot_cache`` captures as CUDA graphs.  Shape cases derive from
``launch/input_specs.py``'s grid the way the reference's do.

Checks per (entry, case):

* the entry runs at all on its canonical shapes (a failure is an ERROR);
* two runs with identical inputs give identical op sequences — a
  mismatch means a Python-scalar closure, global state, or a
  value-dependent branch makes the op sequence nondeterministic;
* every declared static value is hashable.

CACHE-KEY holds what the CUDA-graph cache keys on:
``ProgramCache._key(canonical signature, head config, samples per class,
device)`` rebuilt twice must compare and hash equal, and one key must
give one op sequence — one key maps to one captured graph.
``grid_report()`` gives the per-entry counts.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.core import (Finding, SemanticRule, Severity,
                                       SourceFile)


@dataclasses.dataclass(frozen=True)
class Entry:
    """One public entry point + its canonical shape grid."""
    name: str                      # "module.attr" for reporting
    anchor: str                    # repo-relative file the finding lands on
    build: Callable[[], Callable]  # import + return the callable
    cases: Callable[[], Sequence[Tuple[str, tuple, dict]]]
    # cases() -> [(case_name, args, kwargs)], tensors on ``meta``
    statics: Callable[[], Dict[str, object]] = lambda: {}


def _meta(shape, dtype=None):
    import torch
    return torch.empty(shape, dtype=dtype or torch.float32, device="meta")


def _i64(shape):
    import torch
    return _meta(shape, torch.int64)


def _i32(shape):
    import torch
    return _meta(shape, torch.int32)


def _feature_grid() -> List[Tuple[str, int, int]]:
    """(case, N, d) pairs scaled from the canonical input-shape grid:
    per-client sample counts track the global batch axis, feature dims the
    reduced model width."""
    from repro_torch.models.config import INPUT_SHAPES
    train = INPUT_SHAPES["train_4k"]
    decode = INPUT_SHAPES["decode_32k"]
    return [("train_batch", train.global_batch, 64),
            ("decode_batch", decode.global_batch, 64)]


def _estep_cases():
    return [(case, (_meta((1, N, d)), _meta((4, 8, d)), _meta((4, 8, d)),
                    _meta((4, 8))), {})
            for case, N, d in _feature_grid()]


def _flash_cases():
    from repro_torch.models.config import INPUT_SHAPES
    out = []
    for name in ("train_4k", "prefill_32k"):
        S = INPUT_SHAPES[name].seq_len
        kv = _meta((1, 2, S, 64))
        out.append((name, (_meta((1, 4, S, 64)), kv, kv), {"causal": True}))
    # decode: one query against a long cache
    S = INPUT_SHAPES["decode_32k"].seq_len
    kv = _meta((1, 2, S, 64))
    out.append(("decode_32k", (_meta((1, 4, 1, 64)), kv, kv),
                {"causal": True}))
    return out


def _head_cfg():
    from repro_torch.core.head import HeadConfig
    return HeadConfig(n_steps=8)


def _train_head_cases():
    cfg = _head_cfg()
    out = []
    for case, N, d in _feature_grid():
        bs = min(cfg.batch_size, N)
        out.append((case, (_meta((N, d)), _i32((N,)), 16, cfg),
                    {"draws": {"init": _meta((d, 16)),
                               "idx": _i64((cfg.n_steps, bs))}}))
    return out


def _gmm_cfg():
    from repro_torch.core.gmm import GMMConfig
    return GMMConfig(n_components=4, cov_type="diag", n_iter=3)


def _fit_gmm_batch_cases():
    cfg = _gmm_cfg()
    return [(case, (_meta((2, N, d)), _meta((2, N)), cfg),
             {"init_idx": _i64((2, 4)), "jitter": _meta((2, 4, d))})
            for case, N, d in _feature_grid()]


def _local_train_cases():
    out = []
    for case, N, d in _feature_grid():
        head = {"w": _meta((d, 16)), "b": _meta((16,))}
        out.append((case, (head, _meta((N, d)), _i32((N,)), 16),
                    {"n_steps": 4, "idx": _i64((4, min(256, N)))}))
    return out


def _sample_stacked_cases():
    S, K, d = 64, 4, 32
    return [("slot_64", (_meta((S, K)), _meta((S, K, d)), _meta((S, K, d)),
                         S, "diag"),
             {"draws": {"comp": _i64((S, S)), "eps": _meta((S, S, d))}})]


def _round_sigs():
    """The round program's canonical mini-grid: every layout × a cov-type
    spread, all at power-of-two M (what launch.aot_cache captures)."""
    from repro_torch.fl.round import CohortSignature
    return [
        CohortSignature(M=4, C=8, K=2, d=32, cov_type="diag"),
        CohortSignature(M=4, C=8, K=2, d=32, cov_type="full"),
        CohortSignature(M=16, C=8, K=2, d=32, cov_type="spher"),
        CohortSignature(M=64, C=8, K=2, d=32, cov_type="diag",
                        dtype="float32", layout="slots"),
    ]


def _round_program_cases():
    """Each signature's inputs on ``meta``; full covariance, whose draws
    group by data-dependent sizes (``torch.unique``: no meta kernel, and
    ``launch.aot_cache`` never captures it), runs on the CPU on the
    cache's count-0 identity inputs with a generator seeded 0 — identical
    inputs, identical draws."""
    import torch

    from repro_torch.launch.aot_cache import _identity_inputs
    from repro_torch.launch.input_specs import round_specs_for
    cfg = _head_cfg()
    out = []
    for s in _round_sigs():
        kw = {"sig": s, "head_cfg": cfg, "samples_per_class": None}
        if s.cov_type == "full":
            args = _identity_inputs(s, torch.device("cpu"))
            kw["generator"] = torch.Generator().manual_seed(0)
        else:
            args = tuple(None if sp is None else _meta(*sp)
                         for sp in round_specs_for(s))
        out.append((f"{s.layout}/{s.cov_type}/M{s.M}", args, kw))
    return out


def _imp(module: str, attr: str):
    import importlib
    return getattr(importlib.import_module(module), attr)


def cache_entry_points() -> List[Entry]:
    """Entry points served from the CUDA-graph cache (``launch.aot_cache``)
    — the CACHE-KEY rule's registry.  The statics factory rebuilds the
    static values fresh on every call, which is exactly what
    hash-stability must survive."""
    return [
        Entry("fl.round.round_program", "repro_torch/fl/round.py",
              lambda: _imp("repro_torch.fl.round", "round_program"),
              _round_program_cases,
              lambda: {"sig": _round_sigs()[0], "head_cfg": _head_cfg(),
                       "samples_per_class": None}),
    ]


def entry_points() -> List[Entry]:
    return [
        Entry("kernels.ops.gmm_estep_fused", "repro_torch/kernels/ops.py",
              lambda: _imp("repro_torch.kernels.ops", "gmm_estep_fused"),
              _estep_cases),
        Entry("kernels.ops.attention", "repro_torch/kernels/ops.py",
              lambda: _imp("repro_torch.kernels.ops", "attention"),
              _flash_cases,
              lambda: {"causal": True, "window": 0, "prefix": 0}),
        Entry("core.head.train_head", "repro_torch/core/head.py",
              lambda: _imp("repro_torch.core.head", "train_head"),
              _train_head_cases,
              lambda: {"n_classes": 16, "cfg": _head_cfg()}),
        Entry("core.gmm.fit_gmm_batch", "repro_torch/core/gmm.py",
              lambda: _imp("repro_torch.core.gmm", "fit_gmm_batch"),
              _fit_gmm_batch_cases, lambda: {"cfg": _gmm_cfg()}),
        Entry("fl.baselines.local_train", "repro_torch/fl/baselines.py",
              lambda: _imp("repro_torch.fl.baselines", "local_train"),
              _local_train_cases,
              lambda: {"n_classes": 16, "n_steps": 4, "batch_size": 256,
                       "lr": 1e-3, "prox": 0.0}),
        Entry("fl.api._sample_stacked", "repro_torch/fl/api.py",
              lambda: _imp("repro_torch.fl.api", "_sample_stacked"),
              _sample_stacked_cases,
              lambda: {"S": 64, "cov_type": "diag"}),
        # the CUDA-graph-cached round program rides the same double run —
        # CHURN-RETRACE guards its op sequence, CACHE-KEY its keys
        *cache_entry_points(),
    ]


def op_sequence(fn: Callable, args: tuple, kwargs: dict) -> List[str]:
    """The ATen ops ``fn(*args, **kwargs)`` dispatches, with their output
    shapes (``launch.hlo_cost.OpTrace``)."""
    from repro_torch.launch.hlo_cost import OpTrace
    with OpTrace() as trace:
        fn(*args, **kwargs)
    return trace.ops


def trace_entry(entry: Entry) -> Tuple[List[str], List[Tuple[str, str]]]:
    """Run one entry twice on each case of its grid.

    Returns (one op sequence per case, each verified stable over the
    double run, as text) and a list of (case, error) failures.  Tensors
    on ``meta`` carry shapes alone; a CPU case's inputs are built afresh
    for each run.
    """
    fn = entry.build()
    seqs, errors = [], []
    # the cases are built twice: a case's generator is consumed by its run
    for (case, args, kwargs), (_, args2, kwargs2) in zip(entry.cases(),
                                                         entry.cases()):
        try:
            first = op_sequence(fn, args, kwargs)
            second = op_sequence(fn, args2, kwargs2)
        except Exception as e:  # noqa: BLE001 — any failure is a finding
            errors.append((case, f"{type(e).__name__}: {e}"))
            continue
        if first != second:
            errors.append((case, "RETRACE-DIVERGED"))
        seqs.append("\n".join(first))
    return seqs, errors


def grid_report() -> Dict[str, Dict[str, float]]:
    """Per-entry run stats: cases, distinct op sequences, errors, time."""
    import time
    report = {}
    for entry in entry_points():
        t0 = time.time()
        seqs, errors = trace_entry(entry)
        report[entry.name] = {
            "cases": len(seqs) + len(errors),
            "distinct_op_sequences": len(set(seqs)),
            "errors": len(errors),
            "us": (time.time() - t0) * 1e6,
        }
    return report


class RetraceRule(SemanticRule):
    id = "CHURN-RETRACE"
    severity = Severity.ERROR
    doc = ("a registered entry point fails on its canonical shapes (on "
           "meta), runs a different ATen op sequence on identical inputs, "
           "or carries an unhashable static")
    reference = "CHURN-RETRACE"
    hazard = ("a program whose ops are not a function of its shapes: no "
              "CUDA graph captured once can stand for it")
    anchors = tuple(sorted({e.anchor for e in entry_points()}))

    def __init__(self, entries: Optional[Sequence[Entry]] = None):
        self.entries = entries

    def run_project(self, files: Sequence[SourceFile], device: str):
        findings: List[Finding] = []
        for entry in (self.entries if self.entries is not None
                      else entry_points()):
            src = self.anchor(files, entry.anchor)
            if src is None:
                continue
            try:
                for name, val in entry.statics().items():
                    hash(val)
            except TypeError as e:
                findings.append(self.finding(
                    src, 1,
                    f"{entry.name}: static argument '{name}' is "
                    f"unhashable ({e})",
                    "make the static a frozen dataclass / tuple"))
                continue
            _, errors = trace_entry(entry)
            for case, err in errors:
                if err == "RETRACE-DIVERGED":
                    findings.append(self.finding(
                        src, 1,
                        f"{entry.name}[{case}]: two runs with identical "
                        f"inputs dispatched different op sequences — a "
                        f"Python-scalar closure or a value-dependent "
                        f"branch", "close only over hashable statics; "
                        "branch on shapes, not values"))
                else:
                    findings.append(self.finding(
                        src, 1,
                        f"{entry.name}[{case}] failed on its canonical "
                        f"shapes (meta): {err}",
                        "public entries must run for every canonical "
                        "shape (launch/input_specs.py)"))
        return findings


class CacheKeyRule(SemanticRule):
    """CACHE-KEY: invariants the CUDA-graph cache keys on.

    ``launch.aot_cache.ProgramCache`` keys entries on ``_key(canonical
    CohortSignature, HeadConfig, samples_per_class, device)`` and assumes
    a key that compares equal ALWAYS maps to one captured graph.  Two ways
    that breaks: a key whose hash isn't stable across reconstruction (a
    static growing an unhashable or identity-hashed field — every request
    would miss), and a round program whose op sequence differs between
    runs of the same shapes (one key, many graphs).  Both are checked
    here on the live modules, per entry in :func:`cache_entry_points`.
    """

    id = "CACHE-KEY"
    severity = Severity.ERROR
    doc = ("a CUDA-graph-cached entry's key doesn't hash/compare stably "
           "across reconstruction, or one key gives two op sequences")
    reference = "CACHE-KEY"
    hazard = "every request misses the cache, or a replay runs another program"
    anchors = ("repro_torch/fl/round.py", "repro_torch/launch/aot_cache.py")

    def __init__(self, entries: Optional[Sequence[Entry]] = None):
        self.entries = entries

    def run_project(self, files: Sequence[SourceFile], device: str):
        from repro_torch.launch.aot_cache import ProgramCache
        findings: List[Finding] = []
        src = self.anchor(files, self.anchors[1]) or files[0]
        for entry in (self.entries if self.entries is not None
                      else cache_entry_points()):
            try:
                keys = []
                for _ in range(2):
                    st = entry.statics()
                    keys.append(ProgramCache._key(
                        st["sig"].canonical(), st["head_cfg"],
                        st["samples_per_class"], device))
            except Exception as e:  # noqa: BLE001 — broken factory gates
                findings.append(self.finding(
                    src, 1, f"{entry.name}: key construction failed ({e})",
                    "cache_entry_points() statics must construct cleanly"))
                continue
            try:
                stable = keys[0] == keys[1] and hash(keys[0]) == hash(keys[1])
            except TypeError as e:
                findings.append(self.finding(
                    src, src.line_of("def _key"),
                    f"{entry.name}: the cache key is unhashable ({e}) — it "
                    f"can never find its graph",
                    "key on frozen dataclasses / tuples"))
                continue
            if not stable:
                findings.append(self.finding(
                    src, src.line_of("def _key"),
                    f"{entry.name}: a cache key rebuilt from the same "
                    f"factory compares or hashes unequal — every request "
                    f"would miss the cache",
                    "derive __eq__/__hash__ from value fields only "
                    "(frozen dataclass)"))
            # one cache key ⇒ one op sequence: the double-run machinery
            _, errors = trace_entry(entry)
            for case, err in errors:
                msg = (f"{entry.name}[{case}]: the op sequence diverged "
                       f"across two runs of one cache key — the captured "
                       f"graph would not match a fresh run"
                       if err == "RETRACE-DIVERGED" else
                       f"{entry.name}[{case}] failed: {err}")
                findings.append(self.finding(
                    src, 1, msg,
                    "keep round_program's ops a pure function of "
                    "CohortSignature"))
        return findings
