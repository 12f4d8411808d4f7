"""Wire-level check of Eqs. 9-11 over the process group (port of
``repro/launch/fedpft_dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.fedpft_dryrun [--json PATH]
    torchrun --nproc-per-node=4 -m repro_torch.launch.fedpft_dryrun

Runs ``core.distributed.fedpft_transfer`` (the one-shot round: one bf16
wire all-gather) and ``raw_feature_transfer`` (the Centralized baseline:
every feature row crosses) on a "data" mesh over every rank of the
process group (the CLI starts a 1-rank group in-process when none
exists, and ends it), and compares
the all-gather operand bytes each rank handed over, from the collective
tally, with Eqs. 9-11 and with the raw-feature formula.  The wire
channel's ratio is exactly 1.000.  Times: ``first_us`` is the first call
(the E-step kernel's build and first launches included), ``steady_us``
the best of ``--reps`` more, each a host clock to ``synchronize``.
``--json`` writes the rows to a file of its own.  Under a launcher every
rank runs and tallies its own share; rank 0 prints and writes.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.core import distributed as DF
from repro_torch.core import gmm as G
from repro_torch.launch.mesh import ensure_process_group, make_sim_mesh


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def measure(fn, dev: torch.device, reps: int = 3):
    """{"first_us", "steady_us", "coll", "by_tag"} of ``fn()``: the first
    call timed and tallied, then the best of ``reps`` calls."""
    with DF.record_collectives() as tally:
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        first_us = (time.perf_counter() - t0) * 1e6
    steady = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        steady.append((time.perf_counter() - t0) * 1e6)
    return {"first_us": first_us, "steady_us": min(steady),
            "coll": {k: tally[k] for k in DF.COLLECTIVES},
            "by_tag": dict(tally["by_tag"])}


def run(clients: int = 16, samples: int = 1024, dim: int = 64,
        classes: int = 8, k: int = 5, cov: str = "diag", reps: int = 3,
        device=None, seed: int = 0):
    """Both channels over the process group's ranks → (rows, summary)."""
    dev = resolve_device(device)
    n = dist.get_world_size() if dist.is_initialized() else 1
    mesh = make_sim_mesh(n, device=dev)
    I, N, d, C, K = clients, samples, dim, classes, k
    cfg = G.GMMConfig(n_components=K, cov_type=cov, n_iter=5)
    rng = np.random.default_rng(seed)
    feats = torch.from_numpy(rng.normal(size=(I, N, d)).astype(np.float32)
                             ).to(dev)
    labels = torch.from_numpy(rng.integers(0, C, (I, N)).astype(np.int32)
                              ).to(dev)
    pft = measure(lambda: DF.fedpft_transfer(mesh, feats, labels, C, cfg,
                                             seed=seed), dev, reps)
    raw = measure(lambda: DF.raw_feature_transfer(mesh, feats, labels), dev,
                  reps)
    # per rank, the all-gather operand is its own clients' share
    per_rank = I // n
    pred_pft = DF.expected_wire_bytes(cov, d, K, C, per_rank)
    pred_raw = per_rank * N * d * 2 + per_rank * N * 4
    ag_pft = pft["by_tag"]["wire"]
    ag_raw = raw["coll"]["all-gather"]
    rows = []
    for tag, m, ag, pred in (("fedpft", pft, ag_pft, pred_pft),
                             ("raw", raw, ag_raw, pred_raw)):
        rows.append({"name": f"fedpft_dryrun/{tag}", "ranks": n,
                     "device": str(dev), "all_gather_bytes": ag,
                     "all_gather_total_bytes": m["coll"]["all-gather"],
                     "by_tag": m["by_tag"], "predicted": pred,
                     "ratio": ag / max(pred, 1), "first_us": m["first_us"],
                     "steady_us": m["steady_us"]})
    return rows, {"ratio_wire": ag_pft / max(pred_pft, 1),
                  "ratio_raw": ag_raw / max(pred_raw, 1),
                  "fewer": ag_raw / max(ag_pft, 1), "N": N}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--samples", type=int, default=1024)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--classes", type=int, default=8)
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--cov", default="diag", choices=G.COV_TYPES)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the rows to PATH")
    args = ap.parse_args(argv)
    started = ensure_process_group(args.device)
    try:
        rows, s = run(args.clients, args.samples, args.dim, args.classes,
                      args.k, args.cov, args.reps, args.device)
        rank = dist.get_rank()
    finally:
        if started:
            dist.destroy_process_group()
    if rank:            # each rank's tally is its own; rank 0 reports
        return 0
    pft, raw = rows
    for r in rows:
        print(f"{r['name']},{r['first_us']:.1f},first_us;steady_us="
              f"{r['steady_us']:.1f};all_gather_bytes="
              f"{r['all_gather_bytes']};predicted={r['predicted']}",
              flush=True)
    print(f"FedPFT  transfer: all_gather={pft['all_gather_bytes']:>12d} B   "
          f"Eqs.9-11 predict {pft['predicted']:>12d} B   "
          f"ratio={s['ratio_wire']:.3f}")
    print(f"raw-feature     : all_gather={raw['all_gather_bytes']:>12d} B   "
          f"formula predicts {raw['predicted']:>12d} B   "
          f"ratio={s['ratio_raw']:.3f}")
    print(f"→ parametric transfer moves {s['fewer']:.1f}× fewer bytes over "
          f"the mesh than raw features (N={s['N']}/client; grows linearly "
          f"with N).")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
