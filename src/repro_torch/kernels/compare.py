"""Time versions of the bf16 kernels side by side on one card, in turns.

    python3 src/repro_torch/kernels/compare.py --tree NAME=DIR [--tree ...]
        [--flash NAME=BASE:FILE.cu[:ABLATION] ...] [--rounds 2]
        [--only flash] [--out build/compare.jsonl]

A ``--tree`` is a checkout of the repository: ``.`` for the working tree,
or a commit unpacked into a git-ignored directory, as in
``git archive <commit> | tar -x -C build/exp/<name>``.  A ``--flash``
version is the tree named BASE with its ``csrc/flash_attention.cu``
replaced by FILE (copied to ``build/exp/cmp-<NAME>``; ``kernels/variants/``
holds the measured alternatives), optionally cut by an ABLATION to time
one part of the bf16 kernel alone: ``copies_only`` (the key-tile loop
with its copies and barriers, no products or softmax) or
``products_only`` (no copies after the first two key tiles: products and
softmax on stale tiles).  Ablated versions give wrong outputs by design;
their errors are reported, not checked.  Each round runs
every version in turn, then again in the reverse order (A B … B A), each
in a child process that imports that version's ``repro_torch``, builds
its kernels into the version's own ``build/kernels/``, holds flash at the
encoder's and zamba2-7b's shapes, ``ssd`` at the zamba2-7b path's shape
and the two E-steps against their plain versions, and times each kernel
(and SDPA beside flash) two ways:

- ``single_ms``: the median over 25 calls of an event pair around one
  call, the card idle between calls; this counts the host's work to
  launch the call (the wrapper's checks and its ``ctypes`` call) as well.
- ``device_ms``: 25 calls back to back between two events, the median of
  three such runs, per call: the card's time, the host's launch work
  overlapped with it.

``--only flash`` builds and times flash alone.  Prints one JSON object per
version and round, then a summary; writes both to ``--out``.
``chip_smoke.py`` takes its timers from here.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

N_TIMED = 25
# name: B, H, S, D, causal (the encoder's and zamba2-7b's shared block)
FLASH = {"flash_attention": (256, 16, 64, 80, False),
         "flash_attention_d112": (64, 32, 512, 112, True)}
SSD_MAIN = (64, 112, 512, 64, 64)       # Bt, H, T, N, P; the model's chunk
SSD_CHUNK = 256


def single_call_ms(torch, fn) -> float:
    """Median over N_TIMED calls, each between two CUDA events with the
    card idle before it."""
    for _ in range(5):
        fn()
    times = []
    for _ in range(N_TIMED):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def device_ms(torch, fn) -> float:
    """Device time of one call: N_TIMED calls back to back between two
    CUDA events, the median of three such runs; calls over 2 ms run three
    at a time."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    n = N_TIMED if start.elapsed_time(end) < 2.0 else 3
    runs = []
    for _ in range(3):
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / n)
    return sorted(runs)[1]


def _times(torch, fn) -> dict:
    return {"single_ms": single_call_ms(torch, fn),
            "device_ms": device_ms(torch, fn)}


KERNELS = (*FLASH, "ssd", "estep_fused", "estep")


def child(label: str, only: str = "") -> dict:
    """One version: build, check and time its kernels on the card."""
    import torch
    from repro_torch.kernels import _build, checks, ref
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import gmm_estep as GE
    from repro_torch.kernels import ssd as SSD

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    reports = _build.build(["flash_attention.cu"] if only else
                           ["flash_attention.cu", "ssd.cu", "gmm_estep.cu"])
    res = {"version": label, "tree": str(Path(_build.CSRC).parents[3]),
           "build_s": time.perf_counter() - t0,
           "ptxas_flash": [ln.strip() for ln in
                           reports.get("flash_attention.cu", "").splitlines()
                           if "registers" in ln or "spill" in ln]}
    g = torch.Generator(device=dev).manual_seed(0)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for name, (B, H, S, D, causal) in FLASH.items():
        q, k, v = (torch.randn(B, H, S, D, generator=g, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        got = FA.flash_attention(q, k, v, causal=causal)
        exp = ref.attention_ref(q, k, v, causal=causal)
        res[name] = {"max_abs_err": float((got.float() - exp.float())
                                          .abs().max()),
                     **_times(torch, lambda: FA.flash_attention(
                         q, k, v, causal=causal)),
                     "library": _times(torch, lambda: sdpa(
                         q, k, v, is_causal=causal))}
        del q, k, v, got, exp
    if only:
        return res
    args = checks.ssd_inputs(g, dev, *SSD_MAIN, torch.bfloat16, 0.0,
                             model_like=True)
    got = SSD.ssd(*args, chunk=SSD_CHUNK)
    exp = ref.ssd_ref(*args, chunk=SSD_CHUNK)
    res["ssd"] = {"max_abs_err": max(float((a.float() - b.float()).abs()
                                           .max()) for a, b in zip(got, exp)),
                  **_times(torch, lambda: SSD.ssd(*args, chunk=SSD_CHUNK))}
    del args, got, exp
    x = torch.randn(1, 1000, 1280, generator=g, device=dev)
    mu = torch.randn(10, 10, 1280, generator=g, device=dev)
    var = torch.nn.functional.softplus(
        torch.randn(10, 10, 1280, generator=g, device=dev)) + 0.1
    pi = torch.softmax(torch.randn(10, 10, generator=g, device=dev), -1)
    lp, _ = GE.estep_fused(x, mu, var, pi)
    elp, _ = ref.estep_fused_ref(x, mu, var, pi)
    res["estep_fused"] = {"max_abs_err": float((lp - elp).abs().max()),
                          **_times(torch, lambda: GE.estep_fused(
                              x, mu, var, pi))}
    x0, mu0, var0, pi0 = x[0], mu[0], var[0], pi[0]
    res["estep"] = {"max_abs_err": float(
        (GE.estep(x0, mu0, var0, pi0) - ref.estep_ref(x0, mu0, var0, pi0))
        .abs().max()), **_times(torch, lambda: GE.estep(x0, mu0, var0, pi0))}
    return res


# text edits of the bf16 kernel's key-tile loop (csrc/flash_attention.cu
# and the variants that share its loop)
ABLATIONS = {
    "copies_only": (
        "    if (!(tile < w_pre || (tile >= w_lo && tile < w_hi))) continue;\n",
        "    continue;\n"),
    "products_only": (
        "if (idx + 1 < n_vis) issue(idx + 1, (idx + 1) % NST);",
        "if (idx == 0 && n_vis > 1) issue(1, 1);"),
}


def _versions(args) -> dict:
    root = Path(__file__).resolve().parents[3]
    trees = {}
    for spec in args.tree:
        name, path = spec.split("=", 1)
        trees[name] = Path(path).resolve()
    for spec in args.flash:
        name, rest = spec.split("=", 1)
        base, cu, *cut = rest.split(":")
        text = Path(cu).read_text()
        for c in cut:
            old, new = ABLATIONS[c]
            if old not in text:
                raise ValueError(f"{cu}: no loop line for ablation {c}")
            text = text.replace(old, new)
        dst = root / "build" / "exp" / f"cmp-{name}"
        shutil.rmtree(dst / "src", ignore_errors=True)
        shutil.copytree(trees[base] / "src", dst / "src",
                        ignore=shutil.ignore_patterns("__pycache__"))
        (dst / "src/repro_torch/kernels/csrc/flash_attention.cu").write_text(
            text)
        trees[name] = dst
    return trees


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", action="append", default=[])
    ap.add_argument("--flash", action="append", default=[])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--only", choices=["", "flash"], default="")
    ap.add_argument("--out", default="build/compare.jsonl")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.child, args.only)), flush=True)
        return 0
    trees = _versions(args)
    order = list(trees)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    rows = []
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("w") as f:
        for rnd in range(args.rounds):
            for name in order + order[::-1]:
                env = dict(os.environ, PYTHONPATH=str(trees[name] / "src"))
                p = subprocess.run(
                    [sys.executable, str(Path(__file__).resolve()),
                     "--child", name, "--only", args.only], env=env,
                    capture_output=True, text=True, timeout=900,
                    cwd=trees[name])
                if p.returncode != 0:
                    raise RuntimeError(f"{name}: {p.stderr[-4000:]}")
                row = json.loads(p.stdout.strip().splitlines()[-1])
                row.update(round=rnd, card=card)
                rows.append(row)
                print(json.dumps(row), flush=True)
                f.write(json.dumps(row) + "\n")
        summary = {"card": card, "summary": {
            name: {k: {"single_ms": [r[k]["single_ms"] for r in rows
                                     if r["version"] == name],
                       "device_ms": [r[k]["device_ms"] for r in rows
                                     if r["version"] == name],
                       **({"library_device_ms": [
                           r[k]["library"]["device_ms"] for r in rows
                           if r["version"] == name],
                           "library_single_ms": [
                           r[k]["library"]["single_ms"] for r in rows
                           if r["version"] == name]}
                          if k in FLASH else {})}
                   for k in KERNELS if k in rows[0]}
            for name in order}}
        print(json.dumps(summary), flush=True)
        f.write(json.dumps(summary) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
