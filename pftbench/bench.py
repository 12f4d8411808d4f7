"""The harness's data-driven core: what a cell is, where its pieces live, and
the one result line.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration and a traffic mix.  Everything else is found by name:

  configs/<config>.json       the configuration as it is run (``model``)
  mixes/<traffic>.json        the traffic mix's parameters; its ``kind``
                              picks the generator and the loop,
                              ``workloads/<kind>.py``
  limits/<cell>.json          the limit of every number the cell compares
  metrics/<metric>.py         one reader per metric: ``read(rec)`` returns
                              the metric from the run's record, or None
                              where the record holds nothing to read

The loop fills a record (a dict); each metric's reader turns it into a
number.  A later cell, configuration or metric is new files and entries.
"""
from __future__ import annotations

import importlib.util
import json
import math
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level modules that no process of the benchmark may hold: the JAX
# stack and the JAX package the program was ported from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def spec() -> Dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str, bench: Optional[Dict] = None) -> Dict:
    """The cell's entry with its configuration, mix and limits loaded."""
    bench = bench if bench is not None else spec()
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = dict(found[0])
    conf = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    w["config_file"] = load_json(ROOT / conf["file"])
    w["mix"] = load_json(HERE / "mixes" / f"{w['traffic']}.json")
    w["limits"] = load_json(HERE / "limits" / f"{name}.json")
    return w


def metrics_of(name: str, bench: Dict, trace: bool) -> List[Dict]:
    """The metrics a run of cell ``name`` reports: its end-to-end metrics,
    or with ``trace`` its per-layer ones."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if name in m.get("workloads", [name])]


def _module(path: Path) -> ModuleType:
    spec_ = importlib.util.spec_from_file_location(
        "pftbench_metric_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return mod


def read_metrics(metrics: List[Dict], rec: Dict) -> Dict:
    """{name: {value, unit}} of every metric whose reader finds a value."""
    out = {}
    for m in metrics:
        value = _module(HERE / "metrics" / f"{m['name']}.py").read(rec)
        if value is not None and math.isfinite(value):
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict:
    """Each compared number beside its limit, in the limits' order; a number
    the run could not produce, or that is not finite, reads as missing and
    fails."""
    def value(v):
        return float(v) if v is not None and math.isfinite(v) else None
    return {k: {"value": value(numbers.get(k)), "limit": lim}
            for k, lim in limits.items()}


def passed(checks: Dict) -> bool:
    return all(c["value"] is not None and c["value"] <= c["limit"]
               for c in checks.values())


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is a forbidden one, compared
    whole: ``repro_torch`` is not ``repro``."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def print_checks(checks: Dict) -> None:
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
