#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 pftbench/run.py --workload hubert-xlarge.round --seed 7 \
        --seconds 10 --trace 0

From the root of a checkout that holds the program (``src/repro_torch``) on
a machine with the cards the cell asks for.  ``--trace 0`` reports the
cell's end-to-end metrics, ``--trace 1`` its per-layer ones from a profiled
window.  After the window the run compares what the timed path produced with
the plain reference (``pftbench/reference``) and prints each compared number
beside its limit, last on standard error and last in the result line.  The
last line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics``, ``device`` (and with ``--trace 1`` ``breakdown``).
Without enough CUDA cards, or without the program, it exits nonzero and
prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _environment() -> None:
    """The program and the harness on the import path.  The program builds
    its kernels into the checkout's ``build/kernels``."""
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed is a whole number >= 0")
    _environment()

    import torch
    from pftbench import bench

    spec = bench.spec()
    cell = bench.cell(args.workload, spec)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"pftbench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("pftbench: the program (src/repro_torch) is not in this "
              "checkout", file=sys.stderr)
        return 2
    loop = importlib.import_module(f"pftbench.workloads.{cell['mix']['kind']}")
    rec = loop.run(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   T_START)
    bad = bench.forbidden_modules()
    if bad:
        print(f"pftbench: the run loaded {bad}", file=sys.stderr)
        return 3
    metrics = bench.read_metrics(
        bench.metrics_of(args.workload, spec, bool(args.trace)), rec)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"],
              "memory_peak_bytes": rec["memory_peak_bytes"]}
    breakdown = None
    if args.trace:
        tr = rec["trace"]
        device.update(busy_s=tr["busy_s"] / cell["chips"],
                      window_s=rec["window_s"])
        breakdown = {"device_ops": [list(x) for x in tr["device_ops"][:10]],
                     "idle_gaps": [list(x) for x in tr["idle_gaps"][:10]]}
    torch.cuda.empty_cache()
    checks = bench.judge(loop.compare(rec), cell["limits"])
    result = {"correct": bench.passed(checks) and rec["failed"] == 0,
              "attempted": rec["attempted"], "failed": rec["failed"],
              "metrics": metrics, "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    bench.print_checks(checks)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
