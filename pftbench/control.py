"""The control of the cells' comparison, and the readings that set its
limits.

The control is the reference put in the program's place one precision step
below the configuration's, stage by stage, each stage fed the program's own
output of the stage before: the features of the compared rows through float8
e4m3 products (the model is configured in bfloat16), each client's EM with
its E-step's products in TF32 (configured float32 with TF32 off; the whole
EM in TF32, or in bfloat16, gives NaN variances on hubert-xlarge's
features; its mixtures rounded to the bfloat16 wire), and the server's head trained in bfloat16 (configured
float32) from the clients' wire mixtures and the round's draws.  ``check_control`` and
``service_control`` compute a cell's numbers on the control's outputs, as
the workloads' ``check`` do on the program's; every number must read far
above the program's.

    PYTHONPATH=src python3 -m pftbench.control \
        --workload hubert-xlarge.round --seeds 11,12,13 [--control]

runs, in one process, one round of the program per seed (the cell's sizes,
the run's set-up; a service cell: one window of ``--seconds``) and prints
its numbers, and with ``--control`` the control's beside them: the lower
and upper readings of each limit.  ``--rate`` offers a service cell another
rate: the sweep that finds the highest rate the service sustains.
``--fault <name>[,<name>...]`` plants faults of ``pftbench.faults`` in the
program once the set-up is done: the faults' readings.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict

import numpy as np
import torch

from pftbench import faults as F
from pftbench.reference import gmm as RG
from pftbench.reference import model as RM
from pftbench.workloads import round as R


def tf32_fit(state, feats, labels, seed: int, i: int):
    """Client i's reference EM with its E-step's products in TF32, its
    mixtures rounded to the bfloat16 wire: (mixture, reported
    log-likelihoods)."""
    g = RG.round_generator(seed, 1 + i, state.dev)
    mix, lls = RG.fit_client(feats, labels, state.mix["n_classes"],
                             R.gmm_cfg(state.mix), g, tf32_estep=True)
    return {k: v.to(torch.bfloat16).float() for k, v in mix.items()}, lls


def check_control(rounds: "R.Rounds", out: Dict) -> Dict[str, float]:
    """The cell's numbers of the control put in the program's place of
    round ``out`` (the program's round supplies each stage's input)."""
    r, feats, res = out["r"], out["feats"], out["res"]
    mix = rounds.mix
    d = feats[0].shape[1]
    clients = rounds.pool[r % len(rounds.pool)]
    rows = R.feature_rows(rounds, mix["check"]["feature_rows"])
    inp = torch.cat([i for i, _ in clients])
    idx = torch.from_numpy(rows).to(rounds.dev)
    got = torch.cat([RM.features(rounds.model, rounds.params,
                                 inp[idx[j:j + 8]], mm=RM.fp8_matmul)
                     for j in range(0, len(rows), 8)])
    nums = {"feat_gap": R.feat_gap(rounds, r, rows, got)}
    ll = gain = 0.0
    mixes, counts = [], []
    seed = rounds.round_seed(r)
    for i, ((_, y), f, msg) in enumerate(zip(clients, feats, res.messages)):
        low, low_ll = tf32_fit(rounds, f, y, seed, i)
        ll = R.worst(ll, R.ll_gap(rounds, f, y, low, low_ll))
        gain = R.worst(gain, R.em_gain(rounds, f, y, low))
        mixes.append(R.wire_mix(rounds, msg, d))
        counts.append(np.asarray(msg.header.counts, np.int64))
    low_head = R.ref_head(rounds, seed, mixes, counts, torch.bfloat16)
    nums.update(ll_gap=ll, em_gain=gain,
                head_gap=R.head_gap(rounds, seed, mixes, counts, low_head))
    return nums


def service_control(svc, out) -> Dict[str, float]:
    """The service cell's numbers with the control in the program's place:
    the sampled rows' features from float8 products, the served head's Adam
    in bfloat16 (its labels from both), the sent clients' EM with its E-step
    in TF32."""
    from pftbench.workloads import service as S
    chk = svc.mix["check"]
    ext = S.sample(svc, S.EXTRACT, chk["feature_rows"])
    got = S.ref_features(svc, ext, mm=RM.fp8_matmul)
    ref = S.ref_features(svc, ext)
    head, low_head = S.served_head(svc), S.served_head(svc, torch.bfloat16)
    inf = S.sample(svc, S.INFER, chk["infer_rows"])
    low = S.ref_features(svc, inf, mm=RM.fp8_matmul)
    labels = (low @ low_head["w"] + low_head["b"]).argmax(-1).tolist()
    nums = {"feat_gap": float(((got - ref).abs().amax(-1)
                               / ref.abs().amax(-1).clamp_min(1e-30)).max()),
            "head_gap": R.param_gap(low_head, head),
            "label_gap": S.label_gap(S.ref_features(svc, inf), head, labels)}

    nums.update(S.client_numbers(
        svc, out, low=lambda f, y, seed, c: tf32_fit(svc, f, y, seed, c)))
    return nums


def readings(cell: Dict, seed: int, seconds: float, control: bool,
             faults=(), device="cuda") -> Dict:
    """One seed's program numbers (and the control's) at the cell's sizes:
    one round of a round cell, one window of a service cell; ``faults``
    ``pftbench.faults`` entries planted once the set-up is done."""
    saved = []

    def plant():
        def patch(obj, name, value):
            saved.append((obj, name, getattr(obj, name)))
            setattr(obj, name, value)
        for fault in faults:
            fault(patch)
    try:
        return _readings(cell, seed, seconds, control, plant, device)
    finally:
        for obj, name, value in reversed(saved):
            setattr(obj, name, value)


def _readings(cell: Dict, seed: int, seconds: float, control: bool,
              plant, device) -> Dict:
    model, mix = cell["config_file"]["model"], cell["mix"]
    if mix["kind"] == "round":
        state = R.Rounds(model, mix, seed, device)
        state.warm_up()
        plant()
        out = state.run(0)
        line = {"phase": out["phase"], "program": R.check(state, out)}
        if control:
            line["control"] = check_control(state, out)
        return line
    from pftbench.workloads import service as S
    state = S.Service(model, mix, seed, seconds, device)
    state.warm_up()
    plant()
    out = state.window()
    kind = state.plan["kind"]
    lat = out["latency_s"]
    line = {"window_s": out["window_s"], "steps": out["steps"],
            "rows": out["rows"], "clients_sent": len(state.messages),
            "extract_p95_ms": 1e3 * float(np.percentile(lat[kind == 0], 95)),
            "infer_p95_ms": 1e3 * float(np.percentile(lat[kind == 1], 95)),
            "program": S.check(state, out)}
    if control:
        line["control"] = service_control(state, out)
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rate", type=float, default=None,
                    help="a service mix's offered rate, for the sweep that "
                    "finds the knee (default: the mix's)")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default="",
                    help="comma-separated: " + ", ".join(sorted(F.FAULTS)))
    args = ap.parse_args(argv)
    from pftbench import bench
    cell = bench.cell(args.workload)
    faults = [F.FAULTS[f] for f in args.fault.split(",") if f]
    if args.rate is not None:
        cell["mix"] = dict(cell["mix"], rate=args.rate)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        line = {"workload": args.workload, "seed": seed, "fault": args.fault,
                **readings(cell, seed, args.seconds, args.control, faults)}
        line["s"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
