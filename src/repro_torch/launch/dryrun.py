"""Dry run of every (architecture × input shape) pair on one H100 (port of
``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --json-out out.json
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --count-only

In the reference a row proves that a pair lowers and compiles on the
production mesh.  Here a row proves that the step runs on the card at
full width, and reports its counted operations and bytes, its roofline
terms, its time and its memory:

  * batch: one shard of the production mesh's data axes — global batch
    / 16 on the single-pod mesh (train_4k 16 × 4096, prefill_32k 2 ×
    32768, decode_32k 8 rows over a 32 768-slot cache, long_500k 1 row
    with ``input_specs.window_for``'s ring of 8192 on the attention
    families), / 32 with ``--multi-pod``;
  * depth: 2 layers, or 6 for zamba2-7b so that one use of its shared
    block runs; widths and sequence lengths are never cut;
  * cuts: rows are halved while the step runs out of the card's memory,
    each cut listed in the row's ``reduced``; a pair whose weights (and,
    to train, gradients and Adam state) exceed the card is a ``skip``
    with its reason, as is one that does not fit at one row;
  * steps: train is one Adam step of ``train.make_train_step``, prefill
    ``serve.make_prefill_step``, decode ``serve.make_decode_step`` at
    position seq − 1 over a cache whose slots are all filled, so the
    cached attention reads every key;
  * report: the step's counted ``flops`` / ``hbm_bytes`` as run
    (``launch.hlo_cost.count`` on ``meta`` with the same cut),
    ``model_flops`` for the same cut, ``useful_ratio``, the roofline
    terms, ``step_ms`` (median of 3 after a warm-up), ``peak_bytes``,
    the card's name and power limit, and two shares of the bf16 peak:
    ``plain_share``, the counted FLOPs over the step time, and
    ``peak_share``, the same less ``masked_flops``.  The plain attention
    computes every (query, key) pair and then masks; the kernels skip the
    masked ones (a causal prefill's upper half).  ``masked_flops`` is each
    plain attention call's counted work, forward and backward, times its
    masked share of pairs.  Both shares still count the plain versions'
    unfused elementwise work, so neither is the card's utilisation.

``--count-only`` counts on ``meta`` without the card (the reference's
lower-only mode), with ``--full-size`` at full depth and global batch.
Without it, and with no card, the CLI raises.  Exit code 1 on any
``fail``.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import subprocess
import sys
import time
import traceback
from typing import Any, Dict, List, Optional

import torch

from repro_torch import optim, resolve_device, serve, train
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import hlo_cost as HC
from repro_torch.launch import input_specs as I
from repro_torch.kernels import ops, ref
from repro_torch.launch import roofline as R
from repro_torch.launch.mesh import (PEAK_FLOPS_BF16, axes_of, data_axes,
                                     make_production_mesh)
from repro_torch.models import model as M
from repro_torch.models.config import INPUT_SHAPES, InputShape, ModelConfig

ADAM_LR = 1e-4


class SkipPair(Exception):
    pass


def depth_for(cfg: ModelConfig) -> int:
    """2 layers; 6 for the hybrid, so one use of its shared block runs."""
    return min(cfg.n_layers, cfg.attn_every if cfg.family == "hybrid"
               else 2)


def rows_for(shape: InputShape, multi_pod: bool = False) -> int:
    """One shard of the production mesh's data axes (≥ 1 row)."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    n = 1
    for a in data_axes(mesh):
        n *= axes_of(mesh)[a]
    return max(1, shape.global_batch // n)


def cut(arch: str, shape_name: str, *, full_size: bool = False,
        multi_pod: bool = False):
    """(cfg, shape) as the pair runs: the depth cut and one shard's rows,
    or the whole config and global batch with ``full_size``."""
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    if full_size:
        return cfg, shape
    cfg = dataclasses.replace(cfg, n_layers=depth_for(cfg))
    return cfg, dataclasses.replace(
        shape, global_batch=rows_for(shape, multi_pod))


def make_batch(cfg: ModelConfig, shape: InputShape, mode: str, device,
               generator: Optional[torch.Generator] = None):
    """The step's batch: token ids uniform over the vocabulary, frames and
    image embeddings N(0, 1), an encoder's mask at p 0.08 (random
    ``generator`` draws), or zeros of the same shapes on ``meta``."""
    out = {}
    for k, (shp, dt) in I.batch_specs_for(cfg, shape, mode).items():
        if generator is None:
            out[k] = torch.zeros(shp, dtype=dt, device=device)
        elif dt == torch.bool:
            out[k] = torch.rand(shp, generator=generator,
                                device=device) < 0.08
        elif dt.is_floating_point:
            out[k] = torch.randn(shp, generator=generator, device=device,
                                 dtype=dt)
        else:
            out[k] = torch.randint(0, cfg.vocab_size, shp,
                                   generator=generator, device=device,
                                   dtype=dt)
    return out


def fill_cache(cache, generator: torch.Generator):
    """Every slot and state of a fresh cache filled with N(0, 0.25²)
    draws, in place: the decode reads real values at every key."""
    for leaf in optim.tree_leaves(cache):
        leaf.copy_(0.25 * torch.randn(leaf.shape, generator=generator,
                                      device=leaf.device))
    return cache


def make_step(cfg: ModelConfig, shape: InputShape, params, device,
              generator: Optional[torch.Generator] = None,
              microbatch: int = 0):
    """A zero-argument callable running the pair's step once on
    ``device`` (``meta``: shapes only; ``generator`` None).
    ``microbatch`` > 0 accumulates the train step over slices of that
    many rows."""
    mode = I.mode_of(cfg, shape)
    window = I.window_for(cfg, shape)
    if mode == "decode":
        cache = M.init_cache(cfg, shape.global_batch, shape.seq_len, window,
                             device=device)
        if generator is not None:
            fill_cache(cache, generator)
        tokens = make_batch(cfg, shape, mode, device, generator)["tokens"]
        step = serve.make_decode_step(cfg, window=window)
        return lambda: step(params, cache, tokens, shape.seq_len - 1)
    batch = make_batch(cfg, shape, mode, device, generator)
    if mode == "prefill":
        step = serve.make_prefill_step(cfg, shape.seq_len, window=window)
        return lambda: step(params, batch)
    opt = optim.adam(ADAM_LR)
    state = opt.init(params)
    step = train.make_train_step(cfg, opt, window=window,
                                 microbatch=microbatch)
    return lambda: step(params, state, batch)


def count_pair(cfg: ModelConfig, shape: InputShape,
               microbatch: int = 0):
    """(the step's operation count, its ``masked_flops``), on ``meta``
    through the plain versions, at the given cut."""
    params = I.params_shapes(cfg)
    with ops.record_calls() as calls:
        cost = HC.count(make_step(cfg, shape, params, "meta",
                                  microbatch=microbatch))
    return cost, masked_flops(calls)


def _attention_work(call) -> float:
    """The counted FLOPs of one plain attention call (``attention``: the
    forward; ``attention_bwd``: its backward) on ``meta``."""
    q, k, v = (torch.zeros(t.shape, dtype=t.dtype, device="meta",
                           requires_grad=call.grad) for t in call.tensors)
    kw = dict(call.kw)
    if call.name == "attention":
        return HC.count(ref.attention_ref, q, k, v, **kw).flops
    o = ref.attention_ref(q, k, v, **kw)
    return HC.count(torch.autograd.grad, o, (q, k, v),
                    torch.zeros_like(o)).flops


def masked_flops(calls) -> float:
    """The plain attention's work on masked (query, key) pairs over the
    recorded calls: each call's counted work times its masked share."""
    work: Dict[Any, float] = {}
    total = 0.0
    for call in calls:
        if call.name not in ("attention", "attention_bwd"):
            continue
        Sq, Sk = call.tensors[0].shape[2], call.tensors[1].shape[2]
        masked = 1.0 - ref.visible_pairs(Sq, Sk, **dict(call.kw)) / (Sq * Sk)
        if masked > 0:
            if call.key not in work:
                work[call.key] = _attention_work(call)
            total += masked * work[call.key]
    return total


def static_bytes(cfg: ModelConfig, mode: str) -> int:
    """Weights, and to train their gradients (the parameters' dtype) and
    Adam's two f32 moments: what a step needs before any activation."""
    n = sum(p.numel() for p in optim.tree_leaves(I.params_shapes(cfg)))
    per = 2 + (2 + 8 if mode == "train" else 0)
    return n * per


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _time_step(fn, n: int = 3, calls: Optional[list] = None
               ) -> List[float]:
    """Wall ms of ``n`` calls after a warm-up, each to ``synchronize``;
    the warm-up's kernel calls appended to ``calls`` when given."""
    if calls is None:
        fn()
    else:
        with ops.record_calls() as warm:
            fn()
        calls.extend(warm)
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return times


def _free() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def run_on_card(cfg: ModelConfig, shape: InputShape, params,
                generator: torch.Generator, reduced: List[str],
                microbatch: int = 0, calls: Optional[list] = None):
    """(shape as run, step ms of 3 calls, peak bytes): the step on the
    card, rows halved while it runs out of memory; the kernel calls of
    the warm-up that ran appended to ``calls`` when given."""
    mode = I.mode_of(cfg, shape)
    total = torch.cuda.get_device_properties(0).total_memory
    need = static_bytes(cfg, mode)
    if need > total:
        what = ("weights, gradients and Adam state" if mode == "train"
                else "weights")
        raise SkipPair(f"{cfg.name} at {cfg.n_layers} layers: "
                       f"{need / 1e9:.1f} GB of {what} > the card's "
                       f"{total / 1e9:.1f} GB")
    while True:
        try:
            _free()
            torch.cuda.reset_peak_memory_stats()
            fn = make_step(cfg, shape, params, params["final_norm"].device,
                           generator, microbatch)
            warm: list = []
            times = _time_step(fn, calls=None if calls is None else warm)
            del fn
            if calls is not None:
                calls.extend(warm)
            return shape, times, torch.cuda.max_memory_allocated()
        except torch.cuda.OutOfMemoryError:
            fn = None
            _free()
            rows = shape.global_batch
            if rows == 1 or rows // 2 < microbatch:
                raise SkipPair(f"{cfg.name} {shape.name}: out of the card's "
                               f"memory at one row")
            reduced.append(f"rows {rows} -> {rows // 2}: out of memory at "
                           f"{rows}")
            shape = dataclasses.replace(shape, global_batch=rows // 2)


def init_weights(arch: str, device=None, seed: int = 0):
    """The pair's weights at the depth cut, random from ``seed``."""
    dev = resolve_device(device)
    cfg = dataclasses.replace(get_config(arch),
                              n_layers=depth_for(get_config(arch)))
    g = torch.Generator(device=dev).manual_seed(seed)
    return M.init_params(cfg, g, device=dev)


def run_pair(arch: str, shape_name: str, *, params=None,
             multi_pod: bool = False, microbatch: int = 0,
             count_only: bool = False, full_size: bool = False,
             act_sharding: bool = True, verbose: bool = True,
             card: Optional[str] = None, seed: int = 0,
             calls: Optional[list] = None) -> Dict[str, Any]:
    """One pair's row.  ``params`` (``init_weights(arch)``) lets a caller
    reuse one arch's weights over its shapes.  ``microbatch`` > 0
    accumulates the train step over slices of that many rows.  ``calls``,
    when given, gets the kernel calls (``ops.Call``) of the step's
    warm-up on the card."""
    t0 = time.perf_counter()
    cfg, shape = cut(arch, shape_name, full_size=full_size,
                     multi_pod=multi_pod)
    mode = I.mode_of(cfg, shape)
    mesh = make_production_mesh(multi_pod=multi_pod)
    row: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mode": mode,
        "window": I.window_for(cfg, shape), "multi_pod": multi_pod,
        "mesh": axes_of(mesh), "n_chips": 1, "depth": cfg.n_layers,
        "seq_len": shape.seq_len, "act_sharding": act_sharding}
    ok, reason = I.pair_supported(cfg, shape)
    if not ok:
        return {**row, "status": "skip", "reason": reason}
    reduced: List[str] = []
    if not count_only:
        dev = resolve_device("cuda")
        if params is None:
            params = init_weights(arch, dev, seed)
        g = torch.Generator(device=dev).manual_seed(seed + 1)
        try:
            shape, times, peak = run_on_card(cfg, shape, params, g, reduced,
                                             microbatch, calls)
        except SkipPair as e:
            return {**row, "status": "skip", "reason": str(e),
                    "reduced": reduced}
        times_sorted = sorted(times)
        row.update(step_ms=times_sorted[1], step_ms_runs=times,
                   peak_bytes=peak, card=card or card_line())
    t1 = time.perf_counter()
    cost, masked = count_pair(cfg, shape, microbatch)
    mf = R.model_flops_for(cfg, shape, mode)
    rl = R.from_count(cost, 1, model_flops=mf)
    row.update(status="ok", rows=shape.global_batch, reduced=reduced,
               count_s=time.perf_counter() - t1,
               dot_flops=cost.dot_flops, elem_flops=cost.elem_flops,
               masked_flops=masked, **rl.row())
    if "step_ms" in row:
        at_peak = row["step_ms"] / 1e3 * PEAK_FLOPS_BF16
        row["plain_share"] = row["flops"] / at_peak
        row["peak_share"] = (row["flops"] - masked) / at_peak
    row["s"] = time.perf_counter() - t0
    if verbose:
        ur = rl.useful_flop_ratio
        ur_s = f"useful={ur:.2f}" if ur else "useful=n/a"
        ms = (f" step={row['step_ms']:.1f}ms share={row['peak_share']:.3f}"
              if "step_ms" in row else "")
        print(f"[dryrun] {arch:24s} {shape_name:12s} rows={row['rows']} "
              f"OK t_comp={rl.t_compute:.4f}s t_mem={rl.t_memory:.4f}s "
              f"bn={rl.bottleneck} {ur_s}{ms}", flush=True)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(INPUT_SHAPES), default=None)
    ap.add_argument("--multi-pod", action="store_true",
                    help="rows are one shard of the (2, 16, 16) mesh's "
                         "pod × data axes")
    ap.add_argument("--all", action="store_true",
                    help="all (arch × shape) pairs")
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--no-act-sharding", action="store_true",
                    help="recorded in the row: on one card the activation "
                         "hook is the identity either way")
    ap.add_argument("--count-only", action="store_true",
                    help="count on meta, no card (the reference's "
                         "lower-only mode)")
    ap.add_argument("--full-size", action="store_true",
                    help="with --count-only: full depth and global batch")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    if args.full_size and not args.count_only:
        ap.error("--full-size counts only: add --count-only")
    if args.all:
        pairs = [(a, s) for a in sorted(ARCHS) for s in INPUT_SHAPES]
    elif args.arch and args.shape:
        pairs = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")
    card = None if args.count_only else card_line()
    rows, weights = [], {}
    for a, s in pairs:
        try:
            if not args.count_only and a not in weights:
                weights.clear()
                _free()
                weights[a] = init_weights(a)
            rows.append(run_pair(
                a, s, params=weights.get(a), multi_pod=args.multi_pod,
                microbatch=args.microbatch, count_only=args.count_only,
                full_size=args.full_size,
                act_sharding=not args.no_act_sharding, card=card))
        except Exception:
            traceback.print_exc()
            rows.append({"arch": a, "shape": s, "status": "fail",
                         "error": traceback.format_exc(limit=3)})
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(rows, f, indent=1, default=str)
    n_ok = sum(r["status"] == "ok" for r in rows)
    n_skip = sum(r["status"] == "skip" for r in rows)
    n_fail = len(rows) - n_ok - n_skip
    print(f"[dryrun] ok={n_ok} skip={n_skip} fail={n_fail}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
