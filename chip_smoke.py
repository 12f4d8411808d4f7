#!/usr/bin/env python3
"""Drive the PyTorch port's FedPFT main path once on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each one against its plain PyTorch version on the card and times
both, then runs the paper's Algorithm 1 through the port's entry points
with four foundation backbones, each at its full width and depth with
random weights from a seed: hubert-xlarge (encoder, 48 layers, d_model
1280), rwkv6-3b (RWKV6, 32 layers, d_model 2560), zamba2-7b (81 Mamba2
layers and a shared attention block, d_model 3584) and
granite-moe-3b-a800m (32 layers of 40 experts, top 8).  Each path:
foundation features → per-client class-wise diag GMMs by batched EM →
bf16 wire → the server's fused head → accuracy against the centralized
oracle.  Launch counters, zeroed before each path and read after it, show
that each path ran through its kernels and never through a plain version.
While each backbone's weights are live, the ``depth`` phase runs two rows
of its first batch through the whole stack layer by layer, three passes in
step: the kernel stack (every flash, ``wkv6`` and ``ssd`` call held against
its plain version in f32 on its own inputs; its features ``features``' bit
for bit), the plain stack in bf16 and the plain stack in f32, with each
layer's carried error of the first two against the third; hubert-xlarge
then serves one batch through ``serve.make_encode_step``.

On hubert-xlarge's features (no feature is extracted twice) six more
paths run, each one line: full-covariance FedPFT (K = 1, the tril-packed
wire, the server's peak memory), DP-FedPFT (Theorem 4.1), a Chain of the
four clients, the streamed and pooled servers, the one-shot head
baselines and FedAvg / FedYogi, and the Theorem 6.1 bound with the
reconstruction attack.  Then four more: the §5.3 shifts (label,
covariate and task, the last two through the encoder on their own
inputs: Centralized, Ensemble, AVG, KD and FedPFT each), streaming
ingest (bitwise the fused round; 56 of 120 slots evicted at capacity
64), the round-program cache (one captured CUDA graph per canonical
cohort signature: bitwise the eager server, faster than it, no capture
in a warm streaming round) and a chaos round under a fault plan (bitwise
an offline round over its survivors).

Serving: granite-3-2b's server (dense and ring) and FedPFTService, each
backbone's server, and the wide configs at full width with their depth
cut (pixtral-12b's image prefix at head dim 160, nemotron-4-340b's
squared-ReLU MLP at 192, grok-1's experts through the server, granite-
34b's MQA): prefill and decode through the kernels, then decode ≡ full
forward on f32 weights with two faulty-cache controls.  Flash and cached
attention are held at head dims 160 and 192 and at a group of 48, and
one MoE layer at full width on the card against the CPU.

Training (``train_phase``): granite-3-2b at full width and depth takes 6
Adam steps through ``train.make_train_step`` on one batch of 8 × 1024
tokens (remat on), its loss falling, through the flash forward and the
hand-written flash backward (held before at ``kernels.checks.BWD_CASES``
against its plain version and autograd, and timed beside SDPA's
backward); hubert-xlarge (48 layers) trains on its masked loss,
granite-moe-3b-a800m (4 layers) with its aux loss, pixtral-12b (4
layers) on its text loss behind a 1024-patch image prefix at head dim
160, rwkv6-3b (all 32 layers) through ``wkv6`` and its hand-written
backward and zamba2-7b (12 of 81 layers) through ``ssd`` and its
backward and the flash backward at D = 112 (both backwards held before at
``kernels.checks.RECUR_BWD_CASES``), their losses falling; one f32 step
each of granite-3-2b, hubert-xlarge, rwkv6-3b, granite-moe-3b-a800m
(dropless, with its aux loss), pixtral-12b (2 layers) and zamba2-7b (6
layers) on the card is held against the same step on the CPU; the
launcher runs 20 steps and its checkpoint restores bitwise.

Mesh (``mesh_phase``, on hubert-xlarge's features): the one-shot round
as a collective, ``FedSession.run_sharded`` on one NCCL rank, its wire
all-gather held to Eqs. 9-11 byte for byte, then ``fedpft_dryrun`` at its
defaults.  Analysis (``analysis_phase``, on hubert-xlarge's features):
``repro_torch.analysis`` over the port and this script with its semantic
rules on the card (every kernel source's launch plan at every probe, no
gating finding), one features batch and the 4-client round under
``sanitize(strict=True)`` (the head bitwise the plain round's), and four
controls that must fire (a NaN into the E-step, an Inf into flash, a
replayed generator state, a plan over 227 KiB).  Dry run (``dryrun_phase``, last): ``launch.dryrun.run_pair``
for every arch × input shape at full width (2 layers, 6 for zamba2-7b;
one shard of the production mesh's rows), one line each: ``ok`` with the
step's time, peak memory and counted operations, or ``skip`` with its
reason.

Prints one JSON object per line; the last line is
``{"ok": true, "device": {...}}``.  Any failed phase raises and the
script exits nonzero.  Without a CUDA card, or without the rest of the
repository beside it, it exits nonzero and prints no result.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): the bounds below
F32_FLOPS = 67e12          # f32 on the CUDA cores (no TF32)
BF16_FLOPS = 989e12        # bf16 tensor cores
HBM_BYTES_S = 3.35e12

ESTEP_TOL = 3e-4           # tests/test_kernels.py
ATTN_TOL_F32 = 2e-3
ATTN_TOL_BF16 = 5e-2
# attention_cached in bf16: the kernel and the plain version each round an
# f32 result to bf16 (at most 1e-3 apart at these shapes, PERF.md §6)
CACHED_TOL_BF16 = 1e-2
# decode ≡ full forward on f32 weights, × max |logit|: between the sound
# decodes and the controls of a faulty cache (PERF.md §6, PR 17)
DECODE_TOL_F32 = 1e-4
WKV6_TOL_F32 = 1e-4        # tests/test_wkv6_kernel.py
SSD_TOL_F32 = 2e-4         # tests/test_ssd_kernel.py
# bf16 recurrences: kernel and plain version each round one f32 result to
# bf16, so they are at most one bf16 step (2^-8 relative) apart
REC_TOL_BF16 = 1e-2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn) -> float:
    """The kernel_time lines' ``ms``: the median over 25 calls of an event
    pair around one call, the card idle before it, so the host's work to
    launch the call counts (``compare.single_call_ms``)."""
    from repro_torch.kernels.compare import single_call_ms
    return single_call_ms(torch, fn)


def device_ms(torch, fn) -> float:
    """The card's time per call, 25 calls back to back (the host's launch
    work overlapped): ``compare.device_ms``."""
    from repro_torch.kernels.compare import device_ms as timer
    return timer(torch, fn)


def graph_ms(torch, fn) -> float:
    """The card's time of one call with no host work: the call captured
    in a CUDA graph and replayed (``compare.graph_ms``)."""
    from repro_torch.kernels.compare import graph_ms as timer
    return timer(torch, fn)


def profiled(torch, fn):
    """(the profiler's events, wall ms) of one call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    return prof.key_averages(), wall_ms


def device_profile(torch, fn, events=None, groups=None) -> dict:
    """Wall time of one call of ``fn`` under torch.profiler, the device
    time of the kernels it ran (top 8 by name) and the device's idle
    share.  The profiler's own cost inflates the wall time.  ``events``,
    a ``profiled`` result, reads that call instead of making one.
    ``groups``, {label: (name substrings)}: each label's device time (the
    kernels whose name holds one of its substrings) and share of busy."""
    prof, wall_ms = events if events is not None else profiled(torch, fn)
    kernels = {}
    for e in prof:
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            ms = float(getattr(e, "self_device_time_total", 0.0)) / 1e3
            if ms > 0:
                kernels[e.key] = kernels.get(e.key, 0.0) + ms
    busy = sum(kernels.values())
    top = sorted(((k[:160], v) for k, v in kernels.items()),
                 key=lambda kv: -kv[1])[:8]
    out = {"wall_ms": wall_ms,
           "device_busy_ms": busy if kernels else None,
           "idle_share": 1.0 - busy / wall_ms if kernels else None,
           "top_kernels_ms": top}
    for label, subs in (groups or {}).items():
        ms = sum(v for k, v in kernels.items() if any(x in k for x in subs))
        out[f"{label}_ms"] = ms
        out[f"{label}_share_of_busy"] = ms / busy if busy else None
    return out


def check_close(torch, name, got, exp, tol, **shape) -> float:
    """max |got − exp|; raises unless |got − exp| ≤ tol + tol·|exp|."""
    torch.cuda.synchronize()
    got, exp = got.float(), exp.float()
    err = (got - exp).abs()
    bad = int((err > tol + tol * exp.abs()).sum())
    finite = bool(torch.isfinite(got).all())
    max_err = float(err.max())
    emit({"phase": "kernel_check", "kernel": name, **shape,
          "max_abs_err": max_err, "max_abs": float(exp.abs().max()),
          "tol": tol, "mismatches": bad, "finite": finite})
    if bad or not finite:
        raise AssertionError(f"{name} {shape}: {bad} elements outside "
                             f"tol {tol} (max abs err {max_err})")
    return max_err


def check_logits(torch, name, got, exp, tol, **shape) -> float:
    """max |got − exp| over a logit vector; raises unless it is at most
    tol · max |exp|.  Two bf16 paths through a deep stack differ by
    rounding that scales with the hidden state, so the logits are held
    to the logit scale, not each logit's own size."""
    torch.cuda.synchronize()
    got, exp = got.float(), exp.float()
    err = (got - exp).abs()
    scale = float(exp.abs().max())
    max_err = float(err.max())
    emit({"phase": "logit_check", "check": name, **shape,
          "max_abs_err": max_err, "rms_err": float(err.square().mean()
                                                   .sqrt()),
          "max_abs": scale, "tol": tol, "bound": tol * scale,
          "argmax_equal": bool((got.argmax(-1) == exp.argmax(-1)).all()),
          "finite": bool(torch.isfinite(got).all())})
    if not (max_err <= tol * scale and torch.isfinite(got).all()):
        raise AssertionError(f"{name} {shape}: max abs err {max_err} over "
                             f"{tol} × max |logit| {scale}")
    return max_err


def kernel_phase(torch, dev, card):
    """Every kernel against its plain version at the main path's and the
    edge shapes; times at the main path's shapes."""
    from repro_torch.kernels import checks, ref
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import gmm_estep as GE

    g = torch.Generator(device=dev)
    g.manual_seed(1)
    res = {}

    # --- E-step: the main path's client call, the cohort, ragged N, K and
    # d, spher, K over several component tiles, K = 1 (kernels.checks)
    for tag, (Bx, B, N, K, d, spher) in checks.ESTEP_CASES.items():
        args = checks.estep_inputs(g, dev, Bx, B, N, K, d, spher)
        lp, lse = GE.estep_fused(*args)
        elp, else_ = ref.estep_fused_ref(*args)
        shape = dict(case=tag, Bx=Bx, B=B, N=N, K=K, d=d, spher=spher,
                     plan=GE.launch_plan(Bx, B, N, K, d)._asdict())
        err = max(check_close(torch, "estep_fused", lp, elp, ESTEP_TOL,
                              output="logp", **shape),
                  check_close(torch, "estep_fused", lse, else_, ESTEP_TOL,
                              output="lse", **shape))
        if tag == "main":
            x, mu, var, pi = args
            flops = 4.0 * B * N * K * d
            nbytes = 4.0 * (Bx * N * d + 2 * B * K * d + B * K + B * N * K
                            + B * N)
            res["estep_fused"] = dict(
                max_abs_err=err,
                ms=time_ms(torch, lambda: GE.estep_fused(x, mu, var, pi)),
                device_ms=device_ms(torch, lambda: GE.estep_fused(
                    x, mu, var, pi)),
                plain_ms=time_ms(torch, lambda: ref.estep_fused_ref(
                    x, mu, var, pi)),
                library_ms=None, flops=flops, bytes=nbytes,
                peak=F32_FLOPS)

    x, mu, var, pi = (a[0] for a in checks.estep_inputs(g, dev, 1, 1, 1000,
                                                        10, 1280))
    err = check_close(torch, "estep", GE.estep(x, mu, var, pi),
                      ref.estep_ref(x, mu, var, pi), ESTEP_TOL, N=1000, K=10,
                      d=1280)
    res["estep"] = dict(
        max_abs_err=err,
        ms=time_ms(torch, lambda: GE.estep(x, mu, var, pi)),
        device_ms=device_ms(torch, lambda: GE.estep(x, mu, var, pi)),
        plain_ms=time_ms(torch, lambda: ref.estep_ref(x, mu, var, pi)),
        library_ms=None, flops=4.0 * 1000 * 10 * 1280,
        bytes=4.0 * (1000 * 1280 + 2 * 10 * 1280 + 10 + 1000 * 10),
        peak=F32_FLOPS)

    # --- attention: the encoder's shape in bf16, then every mask in f32
    cases = [
        # B, H, Hkv, Sq, Sk, D, causal, window, prefix, dtype
        (256, 16, 16, 64, 64, 80, False, 0, 0, torch.bfloat16),
        (2, 8, 8, 128, 128, 64, True, 0, 0, torch.float32),
        (1, 2, 2, 256, 256, 32, True, 64, 0, torch.float32),
        (1, 4, 4, 128, 128, 32, True, 0, 16, torch.float32),
        (2, 8, 2, 128, 128, 64, True, 0, 0, torch.float32),
        (1, 4, 1, 64, 256, 80, True, 0, 0, torch.float32),
        (1, 2, 2, 128, 128, 16, True, 32, 8, torch.float32),
        (1, 2, 2, 200, 200, 128, False, 0, 0, torch.float32),
        (2, 4, 4, 70, 70, 80, False, 0, 0, torch.bfloat16),
        (1, 4, 2, 64, 200, 64, True, 0, 0, torch.bfloat16),
        (1, 2, 2, 128, 128, 16, True, 32, 8, torch.bfloat16),
        (1, 4, 4, 128, 128, 32, True, 0, 16, torch.bfloat16),
        (1, 2, 2, 200, 200, 128, False, 0, 0, torch.bfloat16),
        # zamba2-7b's shared causal block, then ragged in f32
        (64, 32, 32, 512, 512, 112, True, 0, 0, torch.bfloat16),
        (2, 4, 4, 200, 200, 112, True, 0, 0, torch.float32),
        # key tiles skipped: causal, on both sides of a window, below a
        # prefix, queries at the tail of 515 keys
        *((B, H, Hkv, Sq, Sk, D, c, w, p, dt)
          for dt in (torch.bfloat16, torch.float32)
          for B, H, Hkv, Sq, Sk, D, c, w, p in (
              (1, 4, 2, 512, 512, 112, True, 0, 0),
              (1, 2, 2, 512, 512, 64, True, 100, 0),
              (1, 2, 2, 512, 512, 64, True, 0, 130),
              (1, 4, 2, 70, 515, 112, True, 0, 0),
              (2, 2, 2, 200, 200, 80, False, 0, 0))),
    ]
    for B, H, Hkv, Sq, Sk, D, causal, window, prefix, dt in cases:
        q = torch.randn(B, H, Sq, D, generator=g, device=dev).to(dt)
        k = torch.randn(B, Hkv, Sk, D, generator=g, device=dev).to(dt)
        v = torch.randn(B, Hkv, Sk, D, generator=g, device=dev).to(dt)
        kw = dict(causal=causal, window=window, prefix=prefix)
        tol = ATTN_TOL_BF16 if dt == torch.bfloat16 else ATTN_TOL_F32
        err = check_close(torch, "flash_attention",
                          FA.flash_attention(q, k, v, **kw),
                          ref.attention_ref(q, k, v, **kw), tol,
                          B=B, H=H, Hkv=Hkv, Sq=Sq, Sk=Sk, D=D,
                          dtype=str(dt), **kw)
        # time the main paths' shapes: the encoder's, zamba2-7b's D = 112
        key = {(256, 16, 64, 80, False): "flash_attention",
               (64, 32, 512, 112, True): "flash_attention_d112"}.get(
                   (B, H, Sq, D, causal))
        if dt != torch.bfloat16 or key is None:
            continue
        # key tiles the bf16 kernel visits against the full sweep, per
        # block of queries and per warp's rows (a quarter of a block)
        tiles = {}
        for unit, rows in (("block", FA.BQ), ("warp", FA.WARP_ROWS)):
            nq = -(-Sq // rows)
            tiles[f"{unit}_rows"] = rows
            tiles[f"{unit}_tiles_visited"] = B * H * sum(
                n_pre + hi - lo for n_pre, lo, hi in (
                    FA.key_tile_range(i, Sq, Sk, causal, window, prefix,
                                      rows) for i in range(nq)))
            tiles[f"{unit}_tiles_full_sweep"] = B * H * nq * -(-Sk // FA.BKV)
        emit({"phase": "flash_tiles", "kernel": key, "B": B, "H": H,
              "Sq": Sq, "Sk": Sk, "D": D, "causal": causal, **tiles})
        sdpa = torch.nn.functional.scaled_dot_product_attention
        # key pairs a causal query row needs: what this run's data needs
        pairs = Sq * (Sq + 1) / 2 if causal else Sq * Sk
        res[key] = dict(
            max_abs_err=err, shape=[B, H, Sq, D], causal=causal,
            ms=time_ms(torch, lambda: FA.flash_attention(q, k, v, **kw)),
            plain_ms=time_ms(torch, lambda: ref.attention_ref(q, k, v,
                                                              **kw)),
            library_ms=time_ms(torch, lambda: sdpa(q, k, v,
                                                   is_causal=causal)),
            device_ms=device_ms(torch, lambda: FA.flash_attention(
                q, k, v, **kw)),
            library_device_ms=device_ms(torch, lambda: sdpa(
                q, k, v, is_causal=causal)),
            graph_ms=graph_ms(torch, lambda: FA.flash_attention(q, k, v,
                                                                **kw)),
            library_graph_ms=graph_ms(torch, lambda: sdpa(
                q, k, v, is_causal=causal)),
            flops=4.0 * B * H * pairs * D,
            bytes=2.0 * (2 * B * H * Sq * D + 2 * B * Hkv * Sk * D),
            peak=BF16_FLOPS)
    for dt in (torch.float32, torch.bfloat16):
        q = torch.randn(1, 2, 8, 32, generator=g, device=dev).to(dt)
        k = torch.randn(1, 2, 4, 32, generator=g, device=dev).to(dt)
        masked = float(FA.flash_attention(q, k, k, causal=True)[:, :, :4]
                       .abs().max())
        emit({"phase": "kernel_check", "kernel": "flash_attention",
              "case": "rows with no visible key are 0", "dtype": str(dt),
              "max_abs": masked})
        if masked != 0.0:
            raise AssertionError(f"fully masked rows gave {masked}, not 0")

    flash_cases(torch, dev, g, res)
    recurrent_checks(torch, dev, g, res)
    cached_checks(torch, dev, g, res)
    bwd_checks(torch, dev, g, res)
    recur_bwd_checks(torch, dev, g, res)
    rms_norm_checks(torch, dev, g, res)
    moe_layer_checks(torch, card)

    for name, r in res.items():
        r["bound_ms"] = 1e3 * max(r["flops"] / r["peak"],
                                  r["bytes"] / HBM_BYTES_S)
        r["bound_by"] = ("operations" if r["flops"] / r["peak"]
                         >= r["bytes"] / HBM_BYTES_S else "bytes")
        if "design_flops" in r:
            r["design_bound_ms"] = 1e3 * r["design_flops"] / r["design_peak"]
        for row in r.get("by_shape", [r]):
            emit({"phase": "kernel_time", "kernel": name, "card": card,
                  **{k: row[k] for k in ("case", "shape", "ms", "device_ms",
                                         "graph_ms", "plain_ms",
                                         "library_ms", "library_device_ms",
                                         "library_graph_ms", "bound_ms",
                                         "bound_by", "design_bound_ms")
                     if k in row}})
    return res


def flash_cases(torch, dev, g, res):
    """Flash at the wide heads and the widest group
    (``kernels.checks.FLASH_CASES``: pixtral-12b's D = 160 prefill,
    nemotron-4-340b's D = 192, granite-34b's MQA), bf16 (within
    ``checks.FLASH_TOL_BF16``) and f32 against the plain version; bf16
    timed beside SDPA (its K and V repeated over the group: a yardstick,
    never the path)."""
    from repro_torch.kernels import checks, ref
    from repro_torch.kernels import flash_attention as FA
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for tag, (B, H, Hkv, Sq, Sk, D, causal) in checks.FLASH_CASES.items():
        for dt in (torch.bfloat16, torch.float32):
            q = torch.randn(B, H, Sq, D, generator=g, device=dev).to(dt)
            k, v = (torch.randn(B, Hkv, Sk, D, generator=g, device=dev)
                    .to(dt) for _ in range(2))
            tol = (checks.FLASH_TOL_BF16 if dt == torch.bfloat16
                   else ATTN_TOL_F32)
            err = check_close(torch, "flash_attention",
                              FA.flash_attention(q, k, v, causal=causal),
                              ref.attention_ref(q, k, v, causal=causal), tol,
                              case=tag, B=B, H=H, Hkv=Hkv, Sq=Sq, Sk=Sk, D=D,
                              causal=causal, dtype=str(dt))
            if dt != torch.bfloat16:
                continue
            kx, vx = (t.repeat_interleave(H // Hkv, dim=1) for t in (k, v))

            def call():
                return FA.flash_attention(q, k, v, causal=causal)

            def lib():
                return sdpa(q, kx, vx, is_causal=causal)
            pairs = Sq * (Sq + 1) / 2 if causal else Sq * Sk
            res[f"flash_attention/{tag}"] = dict(
                case=tag, max_abs_err=err, shape=[B, H, Hkv, Sq, Sk, D],
                causal=causal, ms=time_ms(torch, call),
                plain_ms=time_ms(torch, lambda: ref.attention_ref(
                    q, k, v, causal=causal)),
                library_ms=time_ms(torch, lib),
                device_ms=device_ms(torch, call),
                library_device_ms=device_ms(torch, lib),
                graph_ms=graph_ms(torch, call),
                library_graph_ms=graph_ms(torch, lib),
                flops=4.0 * B * H * pairs * D,
                bytes=2.0 * (2 * B * H * Sq * D + 2 * B * Hkv * Sk * D),
                peak=BF16_FLOPS)
            del q, k, v, kx, vx


def check_grad(torch, name, got, exp, tol, **shape) -> float:
    """max |got − exp|; raises unless it is at most tol · max |exp| (a
    gradient's entries near 0 carry the rounding of its largest)."""
    torch.cuda.synchronize()
    got, exp = got.float(), exp.float()
    err = float((got - exp).abs().max())
    scale = float(exp.abs().max())
    finite = bool(torch.isfinite(got).all())
    emit({"phase": "kernel_check", "kernel": name, **shape,
          "max_abs_err": err, "max_abs": scale, "tol": tol,
          "bound": tol * scale, "finite": finite})
    if not (err <= tol * scale and finite):
        raise AssertionError(f"{name} {shape}: max abs err {err} over {tol}"
                             f" × max |exp| {scale}")
    return err


def bwd_checks(torch, dev, g, res):
    """Flash attention's backward at ``kernels.checks.BWD_CASES``, f32 and
    bf16: the forward's lse against ``ref.attention_lse_ref`` (rows with
    no visible key at −inf), dq, dk, dv against ``ref.attention_bwd_ref``
    on the kernels' o and lse within ``BWD_TOL_*`` × each gradient's max,
    in f32 also against autograd of ``ref.attention_ref`` where every row
    sees a key (the plain version gives a row with none the mean of v), dq
    exactly 0 on rows with no key.  Timed in bf16 at the training shapes
    (``compare.BWD_TIMED``: granite-3-2b, hubert-xlarge, pixtral-12b,
    nemotron-4-340b's heads and zamba2-7b's shared block) beside the plain
    version and SDPA's backward
    (autograd of ``scaled_dot_product_attention``, K and V repeated over
    the group: a yardstick, never the path)."""
    from repro_torch.kernels import checks, ref
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_attention_bwd as FAB
    from repro_torch.kernels.compare import BWD_TIMED
    sdpa = torch.nn.functional.scaled_dot_product_attention
    t_phase = time.perf_counter()
    shapes = []
    for tag, case in checks.BWD_CASES.items():
        B, H, Hkv, Sq, Sk, D, causal, window, prefix = case
        kw = dict(causal=causal, window=window, prefix=prefix)
        rows = ref.attention_mask(Sq, Sk, device=dev, **kw).any(-1)
        for dt in (torch.float32, torch.bfloat16):
            q, k, v, do = checks.bwd_inputs(g, dev, B, H, Hkv, Sq, Sk, D, dt)
            shape = dict(case=tag, B=B, H=H, Hkv=Hkv, Sq=Sq, Sk=Sk, D=D,
                         dtype=str(dt), **kw)
            o, lse = FA.flash_attention(q, k, v, return_lse=True, **kw)
            check_close(torch, "flash_attention", lse[:, :, rows],
                        ref.attention_lse_ref(q, k, **kw)[:, :, rows],
                        ATTN_TOL_F32, output="lse", **shape)
            if not bool((lse[:, :, ~rows] == -math.inf).all()):
                raise AssertionError(f"{tag}: lse of a row with no key "
                                     "is not -inf")
            got = FAB.flash_attention_bwd(q, k, v, o, lse, do, **kw)
            exp = ref.attention_bwd_ref(q, k, v, o, lse, do, **kw)
            tol = (checks.BWD_TOL_BF16 if dt == torch.bfloat16
                   else checks.BWD_TOL_F32)
            err = max(check_grad(torch, "flash_attention_bwd", a, e, tol,
                                 output=n, against="attention_bwd_ref",
                                 **shape)
                      for n, a, e in zip(("dq", "dk", "dv"), got, exp))
            if float(got[0][:, :, ~rows].abs().sum()) != 0.0:
                raise AssertionError(f"{tag}: dq of a row with no key")
            if dt == torch.float32 and bool(rows.all()):
                leaves = [t.detach().requires_grad_() for t in (q, k, v)]
                ref.attention_ref(*leaves, **kw).backward(do)
                for n, a, t in zip(("dq", "dk", "dv"), got, leaves):
                    check_grad(torch, "flash_attention_bwd", a, t.grad, tol,
                               output=n, against="autograd attention_ref",
                               **shape)
                del leaves
            if tag not in BWD_TIMED or dt != torch.bfloat16:
                continue
            G = H // Hkv
            qs, ks, vs = (t.detach().requires_grad_() for t in (
                q, k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)))
            out = sdpa(qs, ks, vs, is_causal=causal)

            def call():
                return FAB.flash_attention_bwd(q, k, v, o, lse, do, **kw)

            def lib():
                return torch.autograd.grad(out, (qs, ks, vs), do,
                                           retain_graph=True)
            # the five products of 64-key tiles over the visible pairs;
            # q, k, v, o, dO and lse read once, dq, dk, dv written once
            pairs = int(ref.attention_mask(Sq, Sk, device=dev, **kw).sum())
            r = dict(case=tag, max_abs_err=err, shape=[B, H, Hkv, Sq, Sk, D],
                     causal=causal, ms=time_ms(torch, call),
                     device_ms=device_ms(torch, call),
                     graph_ms=graph_ms(torch, call),
                     plain_ms=time_ms(torch, lambda: ref.attention_bwd_ref(
                         q, k, v, o, lse, do, **kw)),
                     library_ms=time_ms(torch, lib),
                     library_device_ms=device_ms(torch, lib),
                     flops=10.0 * B * H * pairs * D,
                     bytes=2.0 * (4 * B * H * Sq * D + 4 * B * Hkv * Sk * D)
                     + 4.0 * B * H * Sq,
                     peak=BF16_FLOPS)
            r["bound_ms"] = 1e3 * max(r["flops"] / r["peak"],
                                      r["bytes"] / HBM_BYTES_S)
            r["bound_by"] = ("operations" if r["flops"] / r["peak"]
                             >= r["bytes"] / HBM_BYTES_S else "bytes")
            shapes.append(r)
            del qs, ks, vs, out
        del q, k, v, do, o, lse, got, exp
    res["flash_attention_bwd"] = dict(shapes[0], by_shape=shapes)
    emit({"phase": "bwd_checks", "s": time.perf_counter() - t_phase})


def rms_norm_checks(torch, dev, g, res):
    """The one-pass norm against its plain version at
    ``kernels.checks.RMS_NORM_CASES``: in bf16 the norm at most one bf16
    step apart and equal on at least 99.9 % of the values, the gated norm
    at most two steps apart (one step of the norm before the product) and
    its kernel's own norm times silu(z) to a step; in f32 within 1e-5
    relative.  Times at the benchmark's rows (``RMS_NORM_TIMED``) beside
    the bound of reading x (and z) and writing the output once, the plain
    version and ``F.rms_norm`` where PyTorch has it (a yardstick, never
    the path)."""
    from repro_torch.kernels import checks, ref
    from repro_torch.kernels import rms_norm as RMS
    lib_norm = getattr(torch.nn.functional, "rms_norm", None)
    shapes = []
    for tag, (rows, d, dt, gated) in checks.RMS_NORM_CASES.items():
        x, gamma, z = checks.rms_norm_inputs(g, dev, rows, d, dt, gated)
        got = RMS.rms_norm(x, gamma, z=z)
        exp = ref.rms_norm_ref(x, gamma, z=z)
        shape = dict(case=tag, rows=rows, d=d, dtype=str(dt), gated=gated,
                     plan=RMS.launch_plan(d, rows, x.element_size())
                     ._asdict())
        if dt == torch.bfloat16:
            steps = checks.bf16_steps(got, exp)
            worst, equal = int(steps.max()), float((steps == 0).float()
                                                   .mean())
            # the gate: the kernel's own norm times silu(z), as the plain
            # expression rounds them, to a step (one step of the norm may
            # be two of the product, whose exponent may be the higher)
            own = (int(checks.bf16_steps(got, RMS.rms_norm(x, gamma) *
                                         torch.nn.functional.silu(z)).max())
                   if gated else 0)
            emit({"phase": "kernel_check", "kernel": "rms_norm", **shape,
                  "max_bf16_steps": worst, "equal_share": equal,
                  "gate_steps_from_own_norm": own})
            if worst > 1 + gated or equal < 0.999 or own > 1:
                raise AssertionError(f"rms_norm {tag}: {worst} bf16 steps "
                                     f"apart, {equal} equal, the gate "
                                     f"{own} steps off")
            err = float((got.float() - exp.float()).abs().max())
        else:
            err = check_close(torch, "rms_norm", got, exp, 1e-5, **shape)
        if tag not in checks.RMS_NORM_TIMED:
            continue

        def call():
            return RMS.rms_norm(x, gamma, z=z)

        def lib():
            return lib_norm(x, (d,), gamma, 1e-6)
        es = x.element_size()
        r = dict(case=tag, shape=[rows, d], gated=gated, max_abs_err=err,
                 ms=time_ms(torch, call), device_ms=device_ms(torch, call),
                 graph_ms=graph_ms(torch, call),
                 plain_ms=time_ms(torch, lambda: ref.rms_norm_ref(
                     x, gamma, z=z)),
                 library_ms=(time_ms(torch, lib)
                             if lib_norm is not None and not gated else None),
                 flops=rows * d * (4.0 + 5.0 * gated),
                 bytes=float(es * (rows * d * (2 + gated) + d)),
                 peak=F32_FLOPS)
        r["bound_ms"] = 1e3 * max(r["flops"] / r["peak"],
                                  r["bytes"] / HBM_BYTES_S)
        r["bound_by"] = ("operations" if r["flops"] / r["peak"]
                         >= r["bytes"] / HBM_BYTES_S else "bytes")
        shapes.append(r)
        del x, gamma, z, got, exp
    res["rms_norm"] = dict(shapes[0], by_shape=shapes)


def few_ms(torch, fn, n: int = 3) -> float:
    """The median of ``n`` event pairs, each around one call, after one
    call to warm up: for plain versions that take a second a call."""
    fn()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[n // 2]


def recur_bwd_work(kernel, dims, dtype_bytes):
    """The bytes that the wkv6 / ssd backward must move (each input read
    once, each output written once; the timed case has no final-state
    gradient, zero in training) and the products of their chunked form (chunk 64) on the
    bf16 tensor cores: the function's bound.  wkv6: per step and (b, h)
    about 10 Dh (C + Dh) (the forward's 4 Dh (C + Dh), twice over and the
    recompute); ssd: C Bᵀ and its gradient for all heads, and per head the
    masked products and the state passes, twice over."""
    e = dtype_bytes
    if kernel == "wkv6":
        B, H, T, Dh = dims
        n = B * H * T * Dh
        return dict(flops=10.0 * n * (64 + Dh),
                    # r, k, v, do read and dr, dk, dv written; lw read and
                    # dlw written (f32); u, du; s0 read, dS0 written
                    bytes=7.0 * e * n + 2 * 4.0 * n + 2 * 4.0 * H * Dh
                    + 2 * 4.0 * B * H * Dh * Dh,
                    peak=BF16_FLOPS)
    Bt, H, T, N, P = dims
    n = Bt * H * T * P
    return dict(flops=3 * 2.0 * Bt * T * 64 * N
                + Bt * H * T * (4 * 2.0 * 64 * P + 4 * 2.0 * N * P),
                # x, dy read and dx written; a read, da written (f32); B, C
                # read, dB, dC written; s0 read, dS0 written
                bytes=3.0 * e * n + 2 * 4.0 * Bt * H * T
                + 4.0 * e * Bt * T * N + 2 * 4.0 * Bt * H * N * P,
                peak=BF16_FLOPS)


def recur_bwd_checks(torch, dev, g, res):
    """The wkv6 and ssd backward kernels at ``kernels.checks.
    RECUR_BWD_CASES`` (rwkv6-3b's and zamba2-7b's training shapes, then
    the other head and state sizes, odd T, lw at −8 over 100 and 1000
    steps, a_log at −2, with s0 and dS_T nonzero), f32 and bf16 (the
    chunked route on the tensor cores): every gradient against the plain version
    (``ref.wkv6_bwd_ref`` / ``ref.ssd_bwd_ref``) and against autograd of
    the plain forward within ``RECUR_BWD_TOL_*`` × its max, and two calls
    bitwise equal.  Timed in bf16 at the training shapes; the plain
    version, a Python loop over T, by ``few_ms``; no single torch call
    computes either backward."""
    from repro_torch.kernels import checks, ref
    from repro_torch.kernels import ssd_bwd as SSDB
    from repro_torch.kernels import wkv6_bwd as WKVB
    kinds = {"wkv6": (WKVB.wkv6_bwd, ref.wkv6_bwd_ref, ref.wkv6_ref,
                      ("dr", "dk", "dv", "dlw", "du", "dS0"), "B,H,T,Dh"),
             "ssd": (SSDB.ssd_bwd, ref.ssd_bwd_ref, ref.ssd_ref,
                     ("dx", "da_log", "dB", "dC", "dS0"), "Bt,H,T,N,P")}
    t_phase = time.perf_counter()
    for tag, (kernel, dims, chunk, scale, fill) in \
            checks.RECUR_BWD_CASES.items():
        fn, plain, fwd, names, dnames = kinds[kernel]
        for dt in (torch.float32, torch.bfloat16):
            args, dout, dS = checks.recur_bwd_inputs(g, dev, kernel, dims,
                                                     dt, scale, fill)
            shape = dict(case=tag, **dict(zip(dnames.split(","), dims)),
                         dtype=str(dt), decay_fill=fill,
                         final_state_grad=dS is not None)
            tol = (checks.RECUR_BWD_TOL_BF16 if dt == torch.bfloat16
                   else checks.RECUR_BWD_TOL_F32)
            got = fn(*args, dout, dS)
            again = fn(*args, dout, dS)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{kernel}_bwd {tag} {dt}: two calls "
                                     "differ")
            exp = plain(*args, dout, dS)
            err = max(check_grad(torch, f"{kernel}_bwd", a, e, tol,
                                 output=nm, against=f"{kernel}_bwd_ref",
                                 **shape)
                      for nm, a, e in zip(names, got, exp))
            del exp
            leaves = [a.detach().clone().requires_grad_() for a in args]
            out, S = fwd(*leaves, chunk=chunk)
            torch.autograd.backward(
                (out, S) if dS is not None else out,
                (dout, dS) if dS is not None else dout)
            for nm, a, leaf in zip(names, got, leaves):
                check_grad(torch, f"{kernel}_bwd", a, leaf.grad, tol,
                           output=nm, against=f"autograd {kernel}_ref",
                           chunk=chunk, **shape)
            del leaves, out, S
            if not (tag.endswith("_train") and dt == torch.bfloat16):
                continue

            def call():
                return fn(*args, dout, dS)
            res[f"{kernel}_bwd"] = dict(
                case=tag, shape=list(dims), max_abs_err=err,
                ms=time_ms(torch, call), device_ms=device_ms(torch, call),
                graph_ms=graph_ms(torch, call),
                plain_ms=few_ms(torch, lambda: plain(*args, dout, dS)),
                library_ms=None, **recur_bwd_work(kernel, dims, 2))
        del args, dout, dS, got, again
    emit({"phase": "recur_bwd_checks", "s": time.perf_counter() - t_phase})


def moe_layer_checks(torch, card):
    """One MoE layer at full width in f32 (``kernels.checks.MOE_CASES``)
    on the card against the same layer on the CPU, same inputs: the same
    routes in the same order, the same drops, the output within 1e-5 ×
    max |y|."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import checks
    for tag, (name, T) in checks.MOE_CASES.items():
        cfg = dataclasses.replace(get_config(name), dtype="float32")
        g = torch.Generator()
        # each MoE case draws its inputs from seed 0, on purpose
        g.manual_seed(0)  # lint: disable=KEY-REUSE
        x, w = checks.moe_inputs(g, cfg, T)
        t0 = time.perf_counter()
        y, routes, drops = checks.moe_run(cfg, x, w)
        cpu_s = time.perf_counter() - t0
        yc, routes_c, drops_c = checks.moe_run(
            cfg, x.cuda(), {k: v.cuda() for k, v in w.items()})
        err = float((yc.cpu() - y).abs().max())
        scale = float(y.abs().max())
        same = bool(torch.equal(routes_c.cpu(), routes))
        emit({"phase": "moe_layer_check", "case": tag, "model": name,
              "card": card, "tokens": T, "d_model": cfg.d_model,
              "experts": cfg.n_experts, "top_k": cfg.top_k,
              "routes_equal": same, "dropped": drops, "dropped_card": drops_c,
              "assignments": T * cfg.top_k, "max_abs_err": err,
              "max_abs": scale, "bound": 1e-5 * scale, "cpu_s": cpu_s})
        if not (same and drops == drops_c and err <= 1e-5 * scale):
            raise AssertionError(f"moe layer {tag}: card and CPU differ "
                                 f"(routes equal {same}, drops {drops_c} "
                                 f"vs {drops}, max abs err {err})")


def cached_work(q, kv_pos, q_pos, Hkv, window):
    """The bytes cached attention must move (the valid K/V slots read once,
    q read and o written once, the positions) and its operations (q·k and
    p·v over the visible pairs), from this call's data."""
    from repro_torch.kernels import ref
    B, H, Sq, D = q.shape
    e = q.element_size()
    valid = int((kv_pos >= 0).sum())
    pairs = int(ref.positions_mask(q_pos, kv_pos, window=window).sum())
    return dict(flops=4.0 * H * pairs * D,
                bytes=2.0 * e * Hkv * valid * D + 2.0 * e * B * H * Sq * D
                + 4.0 * (kv_pos.numel() + q_pos.numel()),
                peak=BF16_FLOPS if e == 2 else F32_FLOPS,
                valid_slots=valid, visible_pairs=pairs)


def cached_checks(torch, dev, g, res):
    """attention_cached against its plain version in bf16 and f32 at the
    serving paths' shapes (kernels.checks.CACHED_CASES): granite-3-2b's
    decode over ragged rows 1 … 1024, a wrapped ring of W = 128, a ring
    prefill chunk of 64 at pos0 > 0, zamba2-7b's decode (Hkv = 32, D =
    112), D = 128 with rows that see no key.  Rows with a visible key are
    compared; the others must be 0.  Times in bf16 beside SDPA with the
    same boolean mask (a yardstick, never the path)."""
    from repro_torch.kernels import attention_cached as CA
    from repro_torch.kernels import checks, ref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    shapes = []
    for tag, case in checks.CACHED_CASES.items():
        B, H, Hkv, Sq, Sk, D, window, kind = case
        for dt in (torch.bfloat16, torch.float32):
            q, k, v, q_pos, kv_pos = checks.cached_inputs(
                g, dev, *case, dtype=dt)
            out = CA.attention_cached(q, k, v, q_pos, kv_pos, window=window)
            exp = ref.attention_positions_ref(q, k, v, q_pos, kv_pos,
                                              window=window)
            mask = ref.positions_mask(q_pos, kv_pos, window=window)
            sel = mask.any(-1)[:, None, :].expand(out.shape[:3])
            tol = CACHED_TOL_BF16 if dt == torch.bfloat16 else ATTN_TOL_F32
            err = check_close(torch, "attention_cached", out[sel], exp[sel],
                              tol, case=tag, B=B, H=H, Hkv=Hkv, Sq=Sq,
                              Sk=int(kv_pos.shape[1]), D=D, window=window,
                              dtype=str(dt))
            masked = float(out[~sel].abs().max()) if (~sel).any() else 0.0
            if masked != 0.0:
                raise AssertionError(f"attention_cached {tag}: rows with no "
                                     f"visible key gave {masked}, not 0")
            if dt != torch.bfloat16:
                continue
            G = H // Hkv
            kx, vx = (t.repeat_interleave(G, dim=1) for t in (k, v))
            am = mask[:, None]

            def call():
                return CA.attention_cached(q, k, v, q_pos, kv_pos,
                                           window=window)

            def lib():
                return sdpa(q, kx, vx, attn_mask=am)
            r = dict(case=tag, shape=[B, H, Hkv, Sq, int(kv_pos.shape[1]), D],
                     window=window, max_abs_err=err,
                     ms=time_ms(torch, call), device_ms=device_ms(torch, call),
                     graph_ms=graph_ms(torch, call),
                     library_graph_ms=graph_ms(torch, lib),
                     plain_ms=time_ms(torch, lambda: ref
                                      .attention_positions_ref(
                                          q, k, v, q_pos, kv_pos,
                                          window=window)),
                     library_ms=time_ms(torch, lib),
                     library_device_ms=device_ms(torch, lib),
                     **cached_work(q, kv_pos, q_pos, Hkv, window))
            r["bound_ms"] = 1e3 * max(r["flops"] / r["peak"],
                                      r["bytes"] / HBM_BYTES_S)
            r["bound_by"] = ("operations" if r["flops"] / r["peak"]
                             >= r["bytes"] / HBM_BYTES_S else "bytes")
            shapes.append(r)
    res["attention_cached"] = dict(shapes[0], by_shape=shapes)


# bf16 ssd at the path's head sizes: tag, (Bt, H, T, N, P), chunk, s0
# scale, and None for the lw fill that only wkv6's cases have
# (kernels.checks.WKV6_BF16): the main path's shape (s0 = 0, as the path
# passes it), then T = 200 and T = 65, which no chunk divides
SSD_BF16 = [("main", (64, 112, 512, 64, 64), 256, 0.0, None),
            ("T=200", (4, 112, 200, 64, 64), 256, 1.0, None),
            ("T=65", (4, 112, 65, 64, 64), 256, 1.0, None)]


def recurrent_checks(torch, dev, g, res):
    """wkv6 and ssd, output and final state: bf16 at the main path's shape,
    at T = 200 (and wkv6 at lw ≡ −8 and lw ≡ 0) against their plain
    versions; f32 at the reference tests' shapes with a nonzero s0 against
    their plain versions; f32 at the paths' head sizes and T = 200 against
    the float64 step recurrence.  Times at the main path's shapes."""
    from repro_torch.kernels import checks, ref
    from repro_torch.kernels import ssd as SSD
    from repro_torch.kernels import wkv6 as WKV

    def check(name, got, exp, tol, **shape):
        return max(check_close(torch, name, a, b, tol, output=o, **shape)
                   for a, b, o in zip(got, exp, ("out", "state")))

    kinds = {"wkv6": (WKV.wkv6, ref.wkv6_ref, checks.wkv6_steps,
                      checks.wkv6_inputs, "B,H,T,Dh", WKV6_TOL_F32,
                      checks.WKV6_BF16, checks.WKV6_SHAPES,
                      checks.WKV6_LONG),
             "ssd": (SSD.ssd, ref.ssd_ref, checks.ssd_steps,
                     checks.ssd_inputs, "Bt,H,T,N,P", SSD_TOL_F32,
                     SSD_BF16, checks.SSD_SHAPES, checks.SSD_LONG)}
    for name, (fn, plain, steps, inputs, dims, tol, bf16_cases, shapes,
               long_shape) in kinds.items():
        cases = [(tag, dims_, chunk, torch.bfloat16, s0s, fill, "plain")
                 for tag, dims_, chunk, s0s, fill in bf16_cases]
        cases += [("ref T%chunk" if c[2] % c[-1] else "ref", c[:-1], c[-1],
                   torch.float32, 1.0, None, "plain") for c in shapes]
        cases.append(("T=200", long_shape[:-1], long_shape[-1],
                      torch.float32, 1.0, None, "float64 steps"))
        for tag, dims_, chunk, dt, s0s, fill, against in cases:
            kw = {} if fill is None else {"lw_fill": fill}
            args = inputs(g, dev, *dims_, dt, s0s,
                          model_like=tag == "main" or fill is not None, **kw)
            if against == "plain":
                exp = plain(*args, chunk=chunk)
            else:
                exp = steps(*(a.double() for a in args))
            err = check(name, fn(*args, chunk=chunk), exp,
                        REC_TOL_BF16 if dt == torch.bfloat16 else tol,
                        case=tag, **dict(zip(dims.split(","), dims_)),
                        chunk=chunk, dtype=str(dt), against=against,
                        **kw)
            if tag == "main":
                res[name] = dict(
                    max_abs_err=err,
                    ms=time_ms(torch, lambda: fn(*args, chunk=chunk)),
                    device_ms=device_ms(torch, lambda: fn(*args,
                                                          chunk=chunk)),
                    plain_ms=time_ms(torch, lambda: plain(*args,
                                                          chunk=chunk)),
                    library_ms=None,
                    **recurrent_work(name, *dims_, chunk=chunk))


# the bf16 kernels' own chunks (csrc/wkv6.cu, csrc/ssd.cu), whatever the
# model's
WKV6_KERNEL_CHUNK = 64
SSD_KERNEL_CHUNK = 64
MMA_FLOPS = 2.0 * 16 * 8 * 16        # one mma.sync m16n8k16


def wkv6_mma_count():
    """mma.sync m16n8k16 per chunk and (b, h) of the bf16 wkv6 kernel, Dh
    padded to 64, four warps of 16 steps: A over the s-tiles before a
    warp's rows and the factorised quadrant of its diagonal tile (three
    products: hi hi, hi lo, lo hi), A v over the s-tiles up to its rows
    and kdecᵀ v (two: A and kdec as hi + lo), rdec S (three)."""
    warps, ks, nt = WKV6_KERNEL_CHUNK // 16, 64 // 16, 64 // 8
    a_off = sum(w * 2 * ks * 3 for w in range(warps))
    a_quad = warps * ks * 3
    a_v = sum((w + 1) * nt * 2 for w in range(warps))
    state = warps * ks * nt * 2
    r_s = warps * ks * nt * 3
    return a_off + a_quad + a_v + state + r_s


def recurrent_work(name, B, H, T, *dims, chunk):
    """The bytes that wkv6 / ssd must move and the operations of their
    chunked form (chunk C) on the bf16 tensor cores: the function's bound.
    ``design_flops`` over ``design_peak``: the bound of the design that
    runs, the tensor-core products of the chunked bf16 kernels (wkv6's
    exact pairs of its diagonal quadrants run on the CUDA cores besides)."""
    if name == "wkv6":
        (Dh,) = dims
        n = B * H * T * Dh
        return dict(
            # r kᵀ and (its masked product) v within a chunk, r S and kᵀ v
            flops=4.0 * n * (chunk + Dh),
            # r, k, v, out bf16; lw f32; u; s0 read, final S written
            bytes=2.0 * 4 * n + 4.0 * n + 4.0 * H * Dh
            + 2 * 4.0 * B * H * Dh * Dh,
            peak=BF16_FLOPS,
            design_flops=MMA_FLOPS * wkv6_mma_count() * B * H
            * -(-T // WKV6_KERNEL_CHUNK),
            design_peak=BF16_FLOPS)
    N, P = dims
    n = B * H * T * P
    # the kernel's products per chunk of L and (b, h), N and P padded to
    # 16 and 64: C Bᵀ and M x over the s ≤ t blocks of 16 (10 of 16 when
    # L = 64), M x, C S and the state update twice (hi + lo halves)
    L, Np, Pp = SSD_KERNEL_CHUNK, max(16, N), 64
    tri = (L // 16) * (L // 16 + 1) / 2 * 16 * 16
    per_chunk = 2.0 * tri * Np + 2 * 2.0 * tri * Pp + 2 * 2.0 * L * Np * Pp \
        + 2 * 2.0 * Pp * L * Np
    return dict(
        # C Bᵀ once per chunk for all heads; (L ⊙ C Bᵀ) x, C S, Bᵀ x per head
        flops=2.0 * B * T * chunk * N + B * H * T * (2.0 * chunk * P
                                                     + 4.0 * N * P),
        # x, y bf16; a f32; B, C bf16; s0 read, final S written
        bytes=2.0 * 2 * n + 4.0 * B * H * T + 2.0 * 2 * B * T * N
        + 2 * 4.0 * B * H * N * P,
        peak=BF16_FLOPS,
        design_flops=per_chunk * B * H * -(-T // L), design_peak=BF16_FLOPS)


def frames_of(np, x, n_frames, frame_dim):
    """Each input vector cut into n_frames frames, zero-padded to the
    encoder's frame_embed_dim (benchmarks/common.py's framing)."""
    n, d_in = x.shape
    per = d_in // n_frames
    fr = x[:, :per * n_frames].reshape(n, n_frames, per)
    return np.pad(fr, ((0, 0), (0, 0), (0, frame_dim - per)))


def tokens_of(np, x, n_bins=4):
    """Each value becomes one token id by uniform binning of [−6, 6] into
    ids 1 … n_bins, clipped at the ends.  The bins are coarse: one id per
    fine bin gives every value its own random embedding, and a mean-pooled
    feature then keeps no class signal; with 512 values in 4 bins, the
    token counts and their order still tell the classes apart."""
    ids = np.floor((x + 6.0) / 12.0 * n_bins).astype(np.int64)
    return 1 + np.clip(ids, 0, n_bins - 1)


def to_cpu(tree):
    return {k: to_cpu(v) if isinstance(v, dict) else v.cpu()
            for k, v in tree.items()}


def n_params_of(tree) -> int:
    return sum(n_params_of(v) if isinstance(v, dict) else v.numel()
               for v in tree.values())


# each backbone's main path: the kernels it must launch, per layer and
# batch, besides the E-step of the client EM
PATHS = {
    "hubert-xlarge": {"flash_attention": lambda cfg: cfg.n_layers,
                      "rms_norm": lambda cfg: 2 * cfg.n_layers + 1},
    "rwkv6-3b": {"wkv6": lambda cfg: cfg.n_layers,
                 "rms_norm": lambda cfg: 3 * cfg.n_layers + 1},
    "zamba2-7b": {"ssd": lambda cfg: cfg.n_layers,
                  "flash_attention": lambda cfg: cfg.n_layers
                  // cfg.attn_every,
                  "rms_norm": lambda cfg: 2 * cfg.n_layers
                  + 2 * (cfg.n_layers // cfg.attn_every) + 1},
    "granite-moe-3b-a800m": {"flash_attention": lambda cfg: cfg.n_layers,
                             "rms_norm": lambda cfg: 2 * cfg.n_layers + 1},
}


def main_path(torch, dev, card, name, keep=None, extra=None):
    """One FedPFT round with ``name``'s features, counted; then where its
    time goes, and its features against the plain CPU path.  ``keep``, a
    dict, receives the features, labels, raw inputs and the round's
    ``comm_bytes`` for the paths that reuse them.  ``extra``, a dict,
    receives the launch counts of the backbone's serving run (``SERVE``),
    made while its weights are alive."""
    import dataclasses
    import gc

    import numpy as np

    from repro_torch import data as D
    from repro_torch.configs import get_config
    from repro_torch.core import fedpft as FP
    from repro_torch.core import gmm as G
    from repro_torch.core import head as H
    from repro_torch.fl import api as A
    from repro_torch.kernels import ops
    from repro_torch.models import layers
    from repro_torch.models import model as M

    cfg = get_config(name)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    t0 = time.perf_counter()
    params = M.init_params(cfg, g)
    torch.cuda.synchronize()
    n_params = n_params_of(params)
    emit({"phase": "init", "model": cfg.name, "family": cfg.family,
          "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "n_params": n_params, "param_bytes": 2 * n_params,
          "s": time.perf_counter() - t0, "card": card})

    if cfg.family == "encoder":
        per_class, batch, key = (400, 100), 256, "frames"
    else:
        per_class, batch, key = (100, 25), 64, "tokens"
    dcfg = D.DatasetConfig(n_classes=10, n_per_class=per_class[0],
                           input_dim=512, class_sep=3.0)
    x, y = D.make_dataset(dcfg)
    xt, yt = D.make_dataset(dataclasses.replace(
        dcfg, n_per_class=per_class[1]), split=1)
    if cfg.family == "encoder":
        inp = frames_of(np, x, 64, cfg.frame_embed_dim)
        inp_t = frames_of(np, xt, 64, cfg.frame_embed_dim)
    else:                                   # T = 512 tokens per sequence
        inp, inp_t = tokens_of(np, x), tokens_of(np, xt)

    def feats_of(a):
        return torch.cat([M.features(cfg, params, {key: a[i:i + batch]})
                          for i in range(0, len(a), batch)])

    ops.reset_launch_counts()
    # ---- the counted run: features → clients → wire → head → accuracy
    t0 = time.perf_counter()
    with layers.record_moe() as moe_rec:
        feats = feats_of(inp)
        feats_t = feats_of(inp_t)
    torch.cuda.synchronize()
    t_feat = time.perf_counter() - t0
    # (token, expert) assignments dropped by MoE capacity, per batch
    moe_drops = [sum(int(dr) for _, dr, _ in moe_rec[i:i + cfg.n_layers])
                 / sum(n for n, _, _ in moe_rec[i:i + cfg.n_layers])
                 for i in range(0, len(moe_rec), cfg.n_layers)]
    y_dev, yt_dev = torch.from_numpy(y).to(dev), torch.from_numpy(yt).to(dev)
    clients = [(feats[p], y_dev[p]) for p in D.iid_shards(len(y), 4)]
    sess = A.FedSession(n_classes=10, summarizer=A.GMMSummarizer(
        G.GMMConfig()))
    res = sess.run(clients, seed=0)
    acc = float(H.accuracy(res.model, feats_t, yt_dev))
    t0 = time.perf_counter()
    head_c, _ = FP.centralized_baseline(clients, 10, FP.FedPFTConfig(),
                                        seed=0)
    acc_c = float(H.accuracy(head_c, feats_t, yt_dev))
    t_central = time.perf_counter() - t0
    # held-out check of the decoded mixtures: mean test log-likelihood of
    # each class under each client's class GMM (gmm.log_prob → estep)
    heldout = []
    for m in res.messages:
        for c in range(10):
            gm = {f: m.params[f][c] for f in G.WIRE_FIELDS}
            heldout.append(float(G.log_prob(feats_t[yt_dev == c], gm,
                                            "diag").mean()))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    # ---- end of the counted run

    n_batches = -(-len(inp) // batch) + -(-len(inp_t) // batch)
    expect = {k: f(cfg) * n_batches for k, f in PATHS[name].items()}
    plain = {k: v for k, v in counts.items() if k.startswith("plain_on")}
    comm = res.info["comm_bytes"]
    payload = sum(len(m.payload) for m in res.messages)
    emit({"phase": "main_path", "model": cfg.name, "card": card,
          "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "seq_len": int(inp.shape[1]), "batch": batch,
          "n_batches": n_batches, "features_s": t_feat,
          "phase_s": res.info["phase_s"], "centralized_s": t_central,
          "n_train": int(feats.shape[0]), "n_test": int(feats_t.shape[0]),
          "n_clients": len(clients), "comm_bytes": comm,
          "payload_bytes": payload, "acc": acc, "acc_centralized": acc_c,
          "heldout_loglik_mean": sum(heldout) / len(heldout),
          "launches": {k: v for k, v in counts.items()
                       if v and not k.startswith("plain_on")},
          "plain_on_cuda": sum(plain.values()),
          **({"moe_drop_share_per_batch": moe_drops,
              "moe_drop_share_mean": sum(moe_drops) / len(moe_drops)}
             if moe_drops else {})})
    if not (torch.isfinite(feats).all() and torch.isfinite(feats_t).all()
            and feats.shape == (len(y), cfg.d_model)):
        raise AssertionError(f"{name}: features are not finite "
                             f"({len(y)}, {cfg.d_model})")
    if comm != payload:
        raise AssertionError(f"{name}: comm_bytes {comm} != Σ len(payload) "
                             f"{payload}")
    if not acc > acc_c - 0.08:                 # tests/test_system.py:70
        raise AssertionError(f"{name}: FedPFT acc {acc} not > centralized "
                             f"{acc_c} − 0.08")
    if not acc_c > 0.5:        # the full-depth features carry the classes
        raise AssertionError(f"{name}: centralized acc {acc_c} ≤ 0.5 on 10 "
                             "classes: the features lost the class signal")
    if not all(math.isfinite(v) for v in heldout):
        raise AssertionError(f"{name}: non-finite held-out log-likelihood")
    for k in ("estep_fused", "estep"):
        if counts[k] < 1:
            raise AssertionError(f"{name}: the main path never launched {k}")
    for k, n in expect.items():
        if counts[k] != n:
            raise AssertionError(f"{name}: {counts[k]} {k} launches, not "
                                 f"{n}")
    if any(plain.values()):
        raise AssertionError(f"{name}: plain versions ran on CUDA tensors: "
                             f"{plain}")
    if cfg.n_experts and len(moe_drops) != n_batches:
        raise AssertionError(f"{name}: {len(moe_rec)} MoE calls, not "
                             f"{cfg.n_layers} per batch")

    # where the time goes: one features batch (and, for the encoder's
    # round, one client and the server)
    parts = [(f"features_batch_{batch}", lambda: M.features(
        cfg, params, {key: inp[:batch]}))]
    if cfg.family == "encoder":
        g2 = torch.Generator(device=dev)
        g2.manual_seed(1)
        f0, y0 = clients[0]
        parts += [
            ("client_fit_and_encode", lambda: sess.encode(
                *sess.client_summary(f0, y0, 0, generator=g2, device=dev))),
            ("server_head", lambda: sess.server_aggregate(
                res.messages, generator=g2, device=dev))]
    moe = {}
    if cfg.n_experts:
        # the binned inputs hold 4 token ids, whose tokens route alike:
        # the same batch on ids drawn across the vocabulary beside it
        spread = np.random.default_rng(0).integers(
            1, cfg.vocab_size, size=inp[:batch].shape)
        part = f"features_batch_{batch}_vocab_ids"
        with layers.record_moe() as rec:
            M.features(cfg, params, {key: spread})
        # the counted run's first batch is the binned batch profiled
        for tag, r in ((part, rec), (parts[0][0], moe_rec[:cfg.n_layers])):
            moe[tag] = {"moe": moe_tally(r), "moe_drop_share_by_layer": [
                int(d) / n for n, d, _ in r]}
        parts.append((part, lambda: M.features(cfg, params, {key: spread})))
    for part, fn in parts:
        emit({"phase": "profile", "model": cfg.name, "part": part,
              "card": card, **moe.get(part, {}),
              **device_profile(torch, fn)})

    # the card's features against the plain CPU path on a small input:
    # the same weights cut to two layers (for the hybrid, two Mamba2
    # layers each followed by the shared block), two samples
    cut = {"n_layers": 2}
    if cfg.family == "hybrid":
        cut["attn_every"] = 1
    cfg2 = dataclasses.replace(cfg, **cut)
    p2 = {k: v for k, v in params.items() if k != "blocks"}
    p2["blocks"] = {k: v[:2] for k, v in params["blocks"].items()}
    small = {key: inp_t[:2]}
    on_card = M.features(cfg2, p2, small)
    t0 = time.perf_counter()
    on_cpu = M.features(cfg2, to_cpu(p2), small, device="cpu")
    check_close(torch, f"features of {name} (2 layers, card vs CPU plain "
                "path)", on_card.cpu(), on_cpu, ATTN_TOL_BF16, n=2,
                **cut, cpu_s=time.perf_counter() - t0)
    if extra is not None:
        extra.update(depth_phase(torch, dev, card, cfg, params, name,
                                 {key: inp[:DEPTH_ROWS]},
                                 {key: inp[:batch]}))
    if keep is not None:
        # features_of keeps the weights alive for the shift phase's inputs
        # until the caller clears ``keep``
        def features_of(raw, weights=params):
            fr = frames_of(np, raw, 64, cfg.frame_embed_dim)
            return torch.cat([M.features(cfg, weights, {key: fr[i:i + batch]})
                              for i in range(0, len(fr), batch)])
        keep.update(feats=feats, feats_t=feats_t, y=y_dev, yt=yt_dev, x=x,
                    xt=xt, comm_fused=comm, features_of=features_of)
    if extra is not None and name in SERVE:
        extra.update(serve_phase(torch, dev, card, cfg, params, name,
                                 **SERVE[name]))
    del params, p2, feats, feats_t, clients, res, sess
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# ---- depth: the main path's stack held layer by layer at full depth

# rows of the main path's first batch that the depth phase runs
DEPTH_ROWS = 2
# the kernel each kind of block calls (``block_plan``)
BLOCK_KERNEL = {"transformer": "flash_attention", "shared": "flash_attention",
                "rwkv6": "wkv6", "mamba2": "ssd"}
# the wrappers of ``kernels.ops`` that the depth phase swaps, and the
# names their kernels count launches under
DEPTH_OPS = {"attention": "flash_attention", "wkv6": "wkv6", "ssd": "ssd",
             "rms_norm": "rms_norm"}


def block_plan(cfg):
    """(kind, index) of each block in the order the stack runs them: the
    transformer or RWKV6 layers, or the hybrid's Mamba2 layers with the
    shared block after every ``attn_every``-th (its use u)."""
    if cfg.family == "hybrid":
        plan = []
        for i in range(cfg.n_layers):
            plan.append(("mamba2", i))
            if (i + 1) % cfg.attn_every == 0:
                plan.append(("shared", i // cfg.attn_every))
        return plan
    kind = "rwkv6" if cfg.family == "ssm" else "transformer"
    return [(kind, i) for i in range(cfg.n_layers)]


def layer_steps(torch, cfg, params, batch, f32=False):
    """The model's own blocks over ``batch``, one layer at a time, the
    stacks indexed as ``select_layers`` does: yields ((kind, index), the
    hidden state (B, S, d)) after each block of ``block_plan``, then
    ("pooled", None) with the (B, d) f32 features, which are those of
    ``models.model.features`` bit for bit.  With ``f32`` the config's
    dtype is f32 and each layer's weights are cast to f32 as its block is
    reached (the shared block once, at its first use): ``features`` on
    f32 weights.  Runs where the parameters live, under the caller's grad
    mode."""
    import dataclasses

    from repro_torch.models import layers
    from repro_torch.models import mamba2 as MB
    from repro_torch.models import model as M
    from repro_torch.models import rwkv as RW

    def cast(w):
        return {k: v.float() for k, v in w.items()} if f32 else w

    dev = params["final_norm"].device
    batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
    if f32:
        cfg = dataclasses.replace(cfg, dtype="float32")
    embed = cast({k: v for k, v in params.items()
                  if k in ("frame_proj", "mask_emb", "embed", "img_proj")})
    x, positions = M._embed_inputs(cfg, embed, batch)
    del embed
    blocks = select_layers(params["blocks"])
    if cfg.family == "ssm":
        zero = M._layer(RW.init_rwkv_state(cfg, x.shape[0], dev, n_layers=1),
                        0)
    elif cfg.family == "hybrid":
        zero = M._layer(MB.init_mamba_state(cfg, 1, x.shape[0], dev), 0)
    shared = None
    for kind, i in block_plan(cfg):
        if kind == "rwkv6":
            x, _ = RW.rwkv_block(cfg, x, cast(blocks[i]), zero)
        elif kind == "mamba2":
            x, _ = MB.mamba_block(cfg, x, cast(blocks[i]), zero)
        else:
            if kind == "shared" and shared is None:
                shared = cast(params["shared_attn"])
            w = shared if kind == "shared" else cast(blocks[i])
            x, _ = M._transformer_block(cfg, x, w, positions=positions)
            del w
        yield (kind, i), x
    h = layers.rms_norm(x, params["final_norm"].float() if f32
                        else params["final_norm"])
    yield ("pooled", None), h.float().mean(dim=1)


def launches_of(counts):
    """(the kernels that ``counts`` saw launched, by name; the plain
    versions' calls on CUDA tensors, in all)."""
    return ({k: v for k, v in counts.items()
             if v and not k.startswith("plain_on")},
            sum(v for k, v in counts.items() if k.startswith("plain_on")))


def depth_phase(torch, dev, card, cfg, params, name, rows, encode_batch):
    """``name``'s stack at full width and depth on ``rows`` (two rows of
    the main path's first batch), layer by layer, three passes in step:

    1. the kernel stack (bf16): the main path's own code, every
       ``ops.attention`` / ``wkv6`` / ``ssd`` / ``rms_norm`` call
       launching its kernel
       and then held against its plain version in f32 on that call's own
       inputs (``check_close``, the dry-run checks' tolerances: a call
       outside them fails the phase);
    2. the plain stack (bf16): the plain versions in place of the four
       kernels;
    3. the plain stack in f32, each layer's weights cast as it is reached.

    Each block's carried error of passes 1 and 2 against pass 3, max |Δh|
    / max |h_f32|, is reported, not gated; every value must be finite.
    Pass 1's features equal ``features`` bit for bit; its launches are the
    main path's per batch, and passes 2 and 3 launch none.  The swap is
    undone in a ``finally``.  For the encoder, ``serve.make_encode_step``
    then runs on ``encode_batch``: flash once a layer, no plain version.
    Returns the launch counts of pass 1 (and of the encode step)."""
    from collections import Counter

    from repro_torch import serve as S
    from repro_torch.kernels import checks, ops, ref
    from repro_torch.models import layers
    from repro_torch.models import model as M

    plain = {"attention": ref.attention_ref, "wkv6": ref.wkv6_ref,
             "ssd": ref.ssd_ref, "rms_norm": ref.rms_norm_ref}
    # the main path runs in bf16: the dry-run checks' bf16 tolerances (the
    # norm rounds its f32 result to bf16, and gated twice more: at most
    # three half steps, 2^-9 relative each)
    tol = {"attention": checks.FLASH_TOL_BF16, "wkv6": REC_TOL_BF16,
           "ssd": REC_TOL_BF16, "rms_norm": REC_TOL_BF16}
    kernel = {n: getattr(ops, n) for n in DEPTH_OPS}
    at = {"step": 0}
    worst = {}

    def held(n):
        def call(*args, **kw):
            out = kernel[n](*args, **kw)
            exp = plain[n](*(a.float() if torch.is_tensor(a) else a
                             for a in args), **kw)
            pairs = (zip(("out",), (out,), (exp,))
                     if n in ("attention", "rms_norm")
                     else zip(("out", "state"), out, exp))
            for o, a, e in pairs:
                err = check_close(torch, DEPTH_OPS[n], a, e, tol[n],
                                  case=f"depth {name}", step=at["step"],
                                  output=o, shape=list(a.shape))
                e = e.float()
                share = float(((a.float() - e).abs()
                               / (tol[n] + tol[n] * e.abs())).max())
                key = f"{DEPTH_OPS[n]}/{o}"
                w = worst.setdefault(key, {"calls": 0, "max_abs_err": 0.0,
                                           "share_of_bound": 0.0})
                w["calls"] += 1
                w["max_abs_err"] = max(w["max_abs_err"], err)
                w["share_of_bound"] = max(w["share_of_bound"], share)
                w["tol"] = tol[n]
            return out
        return call

    swaps = {"kernel": {n: held(n) for n in DEPTH_OPS},
             "plain": plain, "f32": plain}
    torch.cuda.synchronize()
    want = M.features(cfg, params, rows, device=dev.type)
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    runs = {p: layer_steps(torch, cfg, params, rows, f32=p == "f32")
            for p in swaps}
    steps, carried = [], {"kernel": [], "plain": []}
    try:
        with torch.no_grad():
            while True:
                h = {}
                for p, run in runs.items():
                    for n, fn in swaps[p].items():
                        setattr(ops, n, fn)
                    before = launches_of(ops.launch_counts())[0]
                    at["step"] = len(steps) + 1
                    block, h[p] = next(run)
                    if (p != "kernel"
                            and launches_of(ops.launch_counts())[0] != before):
                        raise AssertionError(f"depth {name}: the {p} pass "
                                             f"launched a kernel at {block}")
                for p, t in h.items():
                    if not bool(torch.isfinite(t).all()):
                        raise AssertionError(f"depth {name}: the {p} pass "
                                             f"is not finite at {block}")
                scale = float(h["f32"].abs().max())
                for p in carried:
                    carried[p].append(float(
                        (h[p].float() - h["f32"]).abs().max()) / scale)
                kind, index = block
                if kind != "pooled":
                    hidden = h["kernel"]          # pass 1's last block
                steps.append(block)
                emit({"phase": "depth_layer", "model": name,
                      "step": len(steps), "block": kind, "index": index,
                      "kernel": BLOCK_KERNEL.get(kind),
                      "carried_kernel": carried["kernel"][-1],
                      "carried_plain": carried["plain"][-1],
                      "max_abs_f32": scale})
                if kind == "pooled":
                    break
    finally:
        for n, fn in kernel.items():
            setattr(ops, n, fn)
        for run in runs.values():
            run.close()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = ops.launch_counts()
    launched, plain_calls = launches_of(counts)
    expect = {k: f(cfg) for k, f in PATHS[name].items()}
    bitwise = bool(torch.equal(h["kernel"], want))

    # the carried error at layers 1, 1/4, 1/2, 3/4 and the last, and the
    # first block past which pass 1 carries over twice pass 2's error
    n = len(steps) - 1
    at_points = {q: (carried["kernel"][i - 1], carried["plain"][i - 1])
                 for q, i in (("1", 1), ("1/4", max(1, n // 4)),
                              ("1/2", max(1, n // 2)),
                              ("3/4", max(1, 3 * n // 4)), ("last", n))}
    drift = None
    if carried["kernel"][n - 1] > 2 * carried["plain"][n - 1]:
        first = next(i for i in range(n)
                     if carried["kernel"][i] > 2 * carried["plain"][i])
        drift = {"step": first + 1, "block": steps[first][0],
                 "index": steps[first][1],
                 "kernel": BLOCK_KERNEL[steps[first][0]]}
    emit({"phase": "depth", "model": name, "card": card,
          "rows": int(want.shape[0]), "n_layers": cfg.n_layers,
          "blocks": n, "kinds": dict(Counter(k for k, _ in steps[:-1])),
          "launches": launched, "expected_launches": expect,
          "plain_calls": plain_calls,
          "held": worst, "carried": at_points,
          "carried_pooled": {"kernel": carried["kernel"][-1],
                             "plain": carried["plain"][-1]},
          "kernel_over_2x_plain": drift,
          "features_bitwise": bitwise, "s": seconds})
    if launched != expect:
        raise AssertionError(f"depth {name}: pass 1 launched {launched}, "
                             f"not the main path's {expect} a batch")
    if not bitwise:
        raise AssertionError(f"depth {name}: pass 1's features are not "
                             "features' bit for bit")
    out = {f"depth/{name}": counts}

    if cfg.family == "encoder":
        # the encoder's serving step: one full encode through the kernels
        encode = S.make_encode_step(cfg, device=dev.type)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ops.reset_launch_counts()
        logits = encode(params, encode_batch)
        torch.cuda.synchronize()
        t_encode = time.perf_counter() - t0
        counts = ops.launch_counts()
        launched, plain_calls = launches_of(counts)
        B, Sq = next(iter(encode_batch.values())).shape[:2]
        # the encode step is the stack of pass 1: the same logits on its
        # rows, bit for bit
        same = bool(torch.equal(
            encode(params, rows),
            M._logits(cfg, params, layers.rms_norm(
                hidden, params["final_norm"]))))
        emit({"phase": "encode_step", "model": name, "card": card,
              "batch": int(B), "seq_len": int(Sq),
              "logits_shape": list(logits.shape), "s": t_encode,
              "launches": launched, "plain_on_cuda": plain_calls,
              "finite": bool(torch.isfinite(logits).all()),
              "pass1_logits_bitwise": same})
        if launched != {"flash_attention": cfg.n_layers,
                        "rms_norm": 2 * cfg.n_layers + 1} or plain_calls:
            raise AssertionError(f"encode step of {name}: launches "
                                 f"{launched}, plain {plain_calls}")
        if (tuple(logits.shape) != (B, Sq, cfg.vocab_size)
                or not bool(torch.isfinite(logits).all()) or not same):
            raise AssertionError(f"encode step of {name}: logits "
                                 f"{tuple(logits.shape)}, finite or "
                                 "equal to pass 1's failed")
        out[f"encode_step/{name}"] = counts
    return out


# the serving runs of each decode-capable backbone: the server's pool,
# the requests (prompt lengths drawn from [lo, hi] with seed 0) and the
# tokens each generates; granite-3-2b also runs a ring of 128 slots
SERVE = {"granite-3-2b": dict(n_slots=8, max_seq=1024, n_req=24,
                              lengths=(16, 512), max_new=32),
         "granite-moe-3b-a800m": dict(n_slots=4, max_seq=640, n_req=8,
                                      lengths=(64, 512), max_new=16),
         "granite-3-2b/ring": dict(n_slots=4, max_seq=1024, n_req=4,
                                   lengths=(200, 400), max_new=32,
                                   window=128),
         "rwkv6-3b": dict(n_slots=4, max_seq=640, n_req=8,
                          lengths=(64, 512), max_new=16),
         "zamba2-7b": dict(n_slots=4, max_seq=640, n_req=8,
                           lengths=(64, 512), max_new=16)}
N_SEQUENTIAL = 4          # streams held against their own greedy_generate
BF16_LOGIT_ULP = 1.0 / 64  # one bf16 step at logits of magnitude 2 … 4


def host_split(torch, fn) -> dict:
    """One call of ``fn`` under torch.profiler: the device's idle share
    (``device_profile``) and, from the same call, where the host's time
    went, the top 8 host operations by their own time."""
    events = profiled(torch, fn)
    host = {}
    for e in events[0]:
        ms = float(getattr(e, "self_cpu_time_total", 0.0)) / 1e3
        if ms > 0:
            host[e.key[:80]] = host.get(e.key[:80], 0.0) + ms
    top = sorted(host.items(), key=lambda kv: -kv[1])[:8]
    return {**device_profile(torch, fn, events), "host_self_ms_total":
            sum(host.values()), "top_host_ms": top}


def decode_vs_forward(torch, cfg, params, tag, prompt, nxt, max_seq,
                      window, tol, separates=False, img=None):
    """decode ≡ full forward (tests/test_archs.py:90 and :118): prefill
    ``prompt`` (S tokens, after a vlm's image prefix ``img``), decode
    ``nxt`` at position n_img + S, against ``forward`` on the S + 1
    tokens at the last position; raises unless within ``tol`` × max
    |logit|.  Beside it, the same
    reading of two controls that hand the decode a faulty cache: "stale",
    the prompt's last token never written (a dense cache's row left zero,
    a ring's slot holding the token W earlier, a recurrent state one
    token short), and "pos+1", the token decoded one position late (no
    positions in the ssm family).  ``separates``: also raise unless every
    control reads above the limit, so that the check is shown to tell a
    faulty cache.  Returns (the sound reading, {control: reading})."""
    from repro_torch import serve as SV
    from repro_torch.models import model as M
    L0 = int(prompt.shape[0]) + M.n_img(cfg)
    extra = {} if img is None else {"img": img}
    full, _, _ = M.forward(cfg, params, {"tokens": torch.cat(
        [prompt[None], nxt], 1), **extra}, window=window)
    exp = full[:, -1]
    del full
    prefill = SV.make_prefill_step(cfg, max_seq, window)
    decode = SV.make_decode_step(cfg, window)

    def decoded(context, pos):
        _, cache = prefill(params, {"tokens": context[None], **extra})
        return decode(params, cache, nxt, pos)[0]

    shape = dict(prompt=L0, window=window, dtype=cfg.dtype,
                 capacity_factor=cfg.capacity_factor if cfg.n_experts
                 else None)
    err = check_logits(torch, f"decode of {tag} ≡ full forward",
                       decoded(prompt, L0), exp, tol, **shape)
    runs = {"stale": (prompt[:-1], L0)}
    if cfg.family != "ssm":
        runs["pos+1"] = (prompt, L0 + 1)
    controls = {k: float((decoded(*a).float() - exp).abs().max())
                for k, a in runs.items()}
    bound = tol * float(exp.abs().max())
    emit({"phase": "logit_control", "check": f"decode of {tag}",
          "sound_max_abs_err": err, "bound": bound,
          "controls_max_abs_err": controls, **shape})
    if separates and not min(controls.values()) > bound:
        raise AssertionError(f"decode of {tag} ({cfg.dtype}): a faulty "
                             f"cache reads within the limit {bound}: "
                             f"{controls}")
    return err, controls


def dropless(cfg):
    """``cfg`` with MoE capacity 8 (tests/test_archs.py:94): no
    assignment is dropped, so prefill, decode and a full forward, whose
    groups differ, compute the same function."""
    import dataclasses
    return (dataclasses.replace(cfg, capacity_factor=8.0) if cfg.n_experts
            else cfg)


def drops_of(rec) -> int:
    """Assignments dropped over a ``layers.record_moe`` record."""
    return int(sum(int(d) for _, d, _ in rec))


def moe_tally(rec) -> dict:
    """A ``layers.record_moe`` record summed, the pooled groups
    (prefills, forwards, feature batches) apart from the per-row ones
    (the server's decode steps, each slot its own group): calls,
    (token, expert) assignments and drops of each."""
    t = {f"{k}_{f}": 0 for k in ("pooled", "per_row")
         for f in ("calls", "assignments", "dropped")}
    for n, d, per_row in rec:
        k = "per_row" if per_row else "pooled"
        t[f"{k}_calls"] += 1
        t[f"{k}_assignments"] += n
        t[f"{k}_dropped"] += int(d)
    return t


def check_decode_groups(cfg, tag, tally, decode_steps):
    """The server's decode ran per-row MoE groups, as the reference's
    ``vmap``ped one-row decode: one per-row call a layer and step, none
    dropping at the config's own capacity (a group of one token has
    cap = K; a group pooled over the slots could drop)."""
    want = cfg.n_layers * decode_steps
    if tally["per_row_calls"] != want or tally["per_row_dropped"]:
        raise AssertionError(
            f"{tag}: {tally['per_row_calls']} per-row MoE calls in the "
            f"decode (want {want}), {tally['per_row_dropped']} "
            "assignments dropped")


def streams_vs_greedy(torch, cfg, params, tag, prompts, out, max_new,
                      max_seq, window, tie):
    """The served streams ``out`` of the first ``N_SEQUENTIAL`` prompts
    against each prompt's own ``greedy_generate``: a stream may leave it
    only at a near-tie, a step whose sequential top-2 gap is under
    ``tie``; every step before the first near-tie must match.  Returns
    (per stream: steps checked, matched, first mismatch and its gap; the
    share of tokens that matched)."""
    from repro_torch import serve as SV
    seq, matched, total = [], 0, 0
    for i in range(N_SEQUENTIAL):
        toks, gaps = SV.greedy_generate(cfg, params, prompts[i][None],
                                        max_new, max_seq, window,
                                        with_gaps=True)
        toks, gaps = toks[0].tolist(), gaps[0].tolist()
        stop = next((j for j, g in enumerate(gaps) if g < tie), len(gaps))
        first = next((j for j, (a, b) in enumerate(zip(toks, out[i]))
                      if a != b), None)
        same = sum(a == b for a, b in zip(toks, out[i]))
        matched, total = matched + same, total + len(toks)
        seq.append({"rid": i, "checked_steps": stop, "matched": same,
                    "steps": len(toks), "first_mismatch": first,
                    "gap_at_first_mismatch": (None if first is None
                                              else gaps[first])})
        if first is not None and gaps[first] >= tie:
            raise AssertionError(
                f"{tag} ({cfg.dtype}): stream {i} leaves its "
                f"greedy_generate at step {first}, where the top-2 gap "
                f"{gaps[first]} is not a near-tie (< {tie}); {stop} steps "
                "before the first one")
    return seq, matched / total


def cast_tree(tree, dtype):
    return {k: cast_tree(v, dtype) if isinstance(v, dict) else
            v.to(dtype) if v.is_floating_point() else v
            for k, v in tree.items()}


def f32_checks(torch, card, cfg, params, tag, prompts, nxt, max_new,
               max_seq, window):
    """The serving path's separating checks, on an f32 copy of the
    weights, where two paths differ by f32 rounding alone: decode ≡ full
    forward within ``DECODE_TOL_F32`` × max |logit| while each control of
    a faulty cache reads above that; then the first ``N_SEQUENTIAL``
    prompts served over 2 slots (two wait for a freed slot) against
    their own ``greedy_generate`` up to the first near-tie (twice the f32
    decode ≡ forward error).  No plain version may run.  A MoE model runs
    these dropless (``dropless``; no assignment may drop)."""
    import dataclasses

    from repro_torch.kernels import ops
    from repro_torch.models import layers
    from repro_torch.serve.server import BatchedServer, Request, ServerConfig
    cfg32 = dropless(dataclasses.replace(cfg, dtype="float32"))
    p32 = cast_tree(params, torch.float32)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with layers.record_moe() as rec:
        err, controls = decode_vs_forward(torch, cfg32, p32, tag,
                                          prompts[0], nxt, max_seq, window,
                                          DECODE_TOL_F32, separates=True)
        srv = BatchedServer(cfg32, p32, ServerConfig(
            n_slots=2, max_seq=max_seq, window=window))
        reqs = [Request(rid=i, prompt=p, max_new=max_new)
                for i, p in enumerate(prompts[:N_SEQUENTIAL])]
        out = srv.run(reqs)
        tie = 2.0 * err
        seq, share = streams_vs_greedy(torch, cfg32, p32, tag, prompts, out,
                                       max_new, max_seq, window, tie)
    counts = ops.launch_counts()
    plain = sum(v for k, v in counts.items() if k.startswith("plain_on"))
    emit({"phase": "serve_f32", "model": cfg.name, "run": tag,
          "card": card, "decode_vs_forward_max_abs_err": err,
          "decode_controls_max_abs_err": controls, "tie_gap": tie,
          "sequential": seq, "matched_share": share,
          "s": time.perf_counter() - t0,
          "launches": {k: v for k, v in counts.items()
                       if v and not k.startswith("plain_on")},
          "plain_on_cuda": plain, "moe_dropped": drops_of(rec)})
    del srv
    if plain:
        raise AssertionError(f"{tag} (f32): plain versions ran on CUDA "
                             "tensors")
    if drops_of(rec):
        raise AssertionError(f"{tag} (f32, dropless): {drops_of(rec)} "
                             "assignments dropped")
    del p32


def serve_phase(torch, dev, card, cfg, params, tag, n_slots, max_seq, n_req,
                lengths, max_new, window=0):
    """One serving run of ``BatchedServer`` at full width and depth:
    decode ≡ full forward on the first prompt, then the counted run with
    continuous admission (prefill ms per bucket, decode-step ms, tokens/s),
    then the first ``N_SEQUENTIAL`` streams against their own
    ``greedy_generate`` up to the first near-tie, then one decode step
    under the profiler, then ``f32_checks`` on an f32 copy of the weights.
    A MoE model serves at its own capacity factor and reports the
    assignments dropped, its prefills apart from its decode steps, which
    must drop none (``check_decode_groups``); its decode ≡ forward runs
    dropless, and its
    streams are not held to ``greedy_generate`` here: a bucketed prefill
    groups its padded prompt otherwise than an exact-length one, so their
    drops differ (``f32_checks`` holds them dropless).
    Returns ``{tag + "/serve": launch counts}``."""
    import numpy as np

    from repro_torch import serve as SV
    from repro_torch.kernels import ops
    from repro_torch.models import layers
    from repro_torch.serve.server import BatchedServer, Request, ServerConfig

    rng = np.random.default_rng(0)
    lens = rng.integers(lengths[0], lengths[1] + 1, size=n_req)
    prompts = [torch.from_numpy(rng.integers(1, cfg.vocab_size, size=int(L)))
               .to(dev) for L in lens]

    # ---- decode ≡ full forward (tests/test_archs.py:90 and :118) on the
    # served bf16 weights; the f32 copy below is the check that separates
    nxt = torch.from_numpy(rng.integers(1, cfg.vocab_size, size=(1, 1))) \
        .to(dev)
    err, controls = decode_vs_forward(torch, dropless(cfg), params, tag,
                                      prompts[0], nxt, max_seq, window,
                                      ATTN_TOL_BF16)

    # ---- the served run, counted
    srv = BatchedServer(cfg, params, ServerConfig(
        n_slots=n_slots, max_seq=max_seq, window=window))
    reqs = [Request(rid=i, prompt=p, max_new=max_new)
            for i, p in enumerate(prompts)]
    pending = list(reqs)
    prefill_ms, step_ms = {}, []
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t_run = time.perf_counter()
    with layers.record_moe() as rec:
        while pending or any(r is not None for r in srv.active):
            while pending and srv.free_slots():
                L = int(pending[0].prompt.shape[0])
                key = (SV.pow2_bucket(L, srv.scfg.min_bucket, max_seq)
                       if srv.bucketed else L)
                t0 = time.perf_counter()
                srv.submit(pending.pop(0))  # ends on the first token's sync
                prefill_ms.setdefault(key, []).append(
                    1e3 * (time.perf_counter() - t0))
            if any(r is not None for r in srv.active):
                t0 = time.perf_counter()
                srv.step()                  # ends on the tokens' sync
                step_ms.append(1e3 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    counts = ops.launch_counts()
    out = {r.rid: r.out for r in reqs}
    n_tok = sum(len(v) for v in out.values())

    # ---- batched ≡ sequential up to the first near-tie: two bf16 paths
    # as far apart as the decode ≡ forward error can flip a step whose
    # top-2 gap is under twice that error
    seq, share = (None, None) if cfg.n_experts else streams_vs_greedy(
        torch, cfg, params, tag, prompts, out, max_new, max_seq, window,
        max(2.0 * err, BF16_LOGIT_ULP))
    prof = host_split(torch, lambda: srv._decode(
        params, srv.cache, srv.last_tok, srv.positions))
    plain = sum(v for k, v in counts.items() if k.startswith("plain_on"))
    emit({"phase": "serve", "model": cfg.name, "run": tag, "card": card,
          "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "n_slots": n_slots, "max_seq": max_seq, "window": window,
          "n_requests": n_req, "prompt_lengths": [int(lens.min()),
                                                  int(lens.max())],
          "max_new": max_new, "bucketed": srv.bucketed,
          "prefill_ms_by_bucket": {str(k): float(np.median(v))
                                   for k, v in sorted(prefill_ms.items())},
          "prefill_shapes": srv.prefill_compiles(),
          "decode_steps": len(step_ms),
          "decode_step_ms_median": float(np.median(step_ms)),
          "tokens": n_tok, "wall_s": wall, "tokens_per_s": n_tok / wall,
          "decode_vs_forward_max_abs_err": err,
          "decode_controls_max_abs_err": controls,
          "tie_gap": max(2.0 * err, BF16_LOGIT_ULP),
          "sequential": seq, "matched_share": share,
          "launches": {k: v for k, v in counts.items()
                       if v and not k.startswith("plain_on")},
          "plain_on_cuda": plain, "decode_step_profile": prof,
          **({"capacity_factor": cfg.capacity_factor,
              "moe": moe_tally(rec)} if cfg.n_experts else {})})
    if cfg.n_experts:
        check_decode_groups(cfg, tag, moe_tally(rec), len(step_ms))
    want = {"flash_attention": cfg.family != "ssm" and window == 0,
            "attention_cached": cfg.family != "ssm",
            "wkv6": cfg.family == "ssm", "ssd": cfg.family == "hybrid"}
    for k, needed in want.items():
        if needed and counts[k] < 1:
            raise AssertionError(f"{tag}: the serving run never launched "
                                 f"{k}")
    if plain:
        raise AssertionError(f"{tag}: plain versions ran on CUDA tensors")
    if any(len(v) != max_new for v in out.values()):
        raise AssertionError(f"{tag}: a stream stopped short of {max_new}")
    del srv
    f32_checks(torch, card, cfg, params, tag, prompts, nxt, max_new, max_seq,
               window)
    return {f"{tag}/serve": counts}


def serving_paths(torch, dev, card):
    """granite-3-2b at full width and depth, random bf16 weights from seed
    0: the dense server, the ring server (window 128), and FedPFTService.
    Returns each path's launch counts."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    cfg = get_config("granite-3-2b")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    t0 = time.perf_counter()
    params = M.init_params(cfg, g)
    torch.cuda.synchronize()
    n_params = n_params_of(params)
    emit({"phase": "init", "model": cfg.name, "family": cfg.family,
          "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "n_params": n_params, "param_bytes": 2 * n_params,
          "s": time.perf_counter() - t0, "card": card})
    out = {}
    for tag in ("granite-3-2b", "granite-3-2b/ring"):
        out.update(serve_phase(torch, dev, card, cfg, params, tag,
                               **SERVE[tag]))
    out.update(service_phase(torch, dev, card, cfg, params))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


# the wide and grouped configs at full width with random bf16 weights from
# seed 0, the depth cut (``dataclasses.replace(cfg, n_layers=…)``): the
# depth run, the f32 check's depth, rows, prompt tokens and decode steps;
# pixtral-12b also extracts features of ``features`` samples, and grok-1
# serves its rows through BatchedServer (prompt lengths drawn from a range)
WIDE = {"pixtral-12b": dict(depth=40, f32_depth=4, rows=2, prompt=64,
                            steps=16, features=4),
        "nemotron-4-340b": dict(depth=2, f32_depth=1, rows=2, prompt=256,
                                steps=8),
        "grok-1-314b": dict(depth=4, f32_depth=1, rows=4, prompt=(64, 256),
                            steps=8, server=True),
        "granite-34b": dict(depth=8, f32_depth=1, rows=4, prompt=256,
                            steps=8)}
F32_PROMPT = 48            # prompt tokens of the f32 decode ≡ forward


def wide_phase(torch, dev, card, name, depth, f32_depth, rows, prompt,
               steps, server=False, features=0):
    """One wide config at full width, ``depth`` of its layers: (vlm)
    features of ``features`` samples of 1024 stub patches and ``prompt``
    tokens; a prefill of ``rows`` prompts and ``steps`` greedy decode
    steps (with ``server``, through BatchedServer, each slot its own MoE
    group), counted: flash on every prefill layer, ``attention_cached``
    on every decode layer, no plain version, finite logits.  The weights
    are freed; then decode ≡ full forward on fresh f32 weights at
    ``f32_depth`` layers within ``DECODE_TOL_F32`` × max |logit|, both
    faulty-cache controls above it, dropless.  A MoE config reports the
    assignments dropped at its own capacity, the server's decode steps
    apart (``check_decode_groups``: none may drop).  Returns ``{name:
    launch counts}``."""
    import dataclasses
    import gc

    import numpy as np

    from repro_torch import serve as SV
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import layers
    from repro_torch.models import model as M
    from repro_torch.serve.server import BatchedServer, Request, ServerConfig

    base = get_config(name)
    cfg = dataclasses.replace(base, n_layers=depth)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    t0 = time.perf_counter()
    params = M.init_params(cfg, g)
    torch.cuda.synchronize()
    n_params = n_params_of(params)
    emit({"phase": "init", "model": cfg.name, "family": cfg.family,
          "n_layers": depth, "of_layers": base.n_layers,
          "d_model": cfg.d_model, "head_dim": cfg.head_dim,
          "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
          "n_params": n_params, "param_bytes": 2 * n_params,
          "s": time.perf_counter() - t0, "card": card})
    rng = np.random.default_rng(0)
    n_img = M.n_img(cfg)

    def img_of(n):              # the stubbed vision frontend's output
        return torch.randn(n, cfg.n_img_tokens, cfg.img_embed_dim,
                           generator=g, device=dev)

    def tokens_of_len(*shape):
        return torch.from_numpy(rng.integers(1, cfg.vocab_size,
                                             size=shape)).to(dev)
    longest = max(prompt) if isinstance(prompt, tuple) else prompt
    max_seq = n_img + longest + steps + 1
    line, prefill_ms, step_ms = {}, [], []
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with layers.record_moe() as rec:
        if features:
            t0 = time.perf_counter()
            f = M.features(cfg, params, {"tokens": tokens_of_len(
                features, prompt), "img": img_of(features)})
            torch.cuda.synchronize()
            line["features_s"] = time.perf_counter() - t0
            if not (f.shape == (features, cfg.d_model)
                    and torch.isfinite(f).all()):
                raise AssertionError(f"{name}: features not finite "
                                     f"({features}, {cfg.d_model})")
        if server:
            srv = BatchedServer(cfg, params, ServerConfig(n_slots=rows,
                                                          max_seq=max_seq))
            lens = rng.integers(prompt[0], prompt[1] + 1, size=rows)
            reqs = [Request(rid=i, prompt=tokens_of_len(int(L)),
                            max_new=steps + 1) for i, L in enumerate(lens)]
            for r in reqs:
                t0 = time.perf_counter()
                srv.submit(r)                # ends on the first token's sync
                prefill_ms.append(1e3 * (time.perf_counter() - t0))
            while any(r is not None for r in srv.active):
                t0 = time.perf_counter()
                srv.step()
                step_ms.append(1e3 * (time.perf_counter() - t0))
            n_prefill, last = rows, None
            line["prompt_lengths"] = [int(L) for L in lens]
            line["streams"] = [r.out for r in reqs]
            if any(len(r.out) != steps + 1 for r in reqs):
                raise AssertionError(f"{name}: a stream stopped short")
        else:
            batch = {"tokens": tokens_of_len(rows, prompt)}
            if n_img:
                batch["img"] = img_of(rows)
            prefill = SV.make_prefill_step(cfg, max_seq)
            decode = SV.make_decode_step(cfg)
            t0 = time.perf_counter()
            last, cache = prefill(params, batch)
            torch.cuda.synchronize()
            prefill_ms.append(1e3 * (time.perf_counter() - t0))
            for i in range(steps):
                t0 = time.perf_counter()
                tok = torch.argmax(last, -1)[:, None]
                last, cache = decode(params, cache, tok, n_img + prompt + i)
                torch.cuda.synchronize()
                step_ms.append(1e3 * (time.perf_counter() - t0))
            n_prefill = 1
            del cache
        torch.cuda.synchronize()
    counts = ops.launch_counts()
    plain = sum(v for k, v in counts.items() if k.startswith("plain_on"))
    expect = {"flash_attention": depth * (n_prefill + bool(features)),
              "attention_cached": depth * steps}
    emit({"phase": "wide", "model": cfg.name, "card": card,
          "n_layers": depth, "of_layers": base.n_layers,
          "d_model": cfg.d_model, "head_dim": cfg.head_dim,
          "group": cfg.n_heads // cfg.n_kv_heads, "rows": rows,
          "prompt": prompt, "n_img": n_img, "decode_steps": steps,
          "server": server, "prefill_ms": prefill_ms,
          "decode_step_ms_median": float(np.median(step_ms)),
          "decode_step_ms": step_ms, **line,
          "launches": {k: v for k, v in counts.items()
                       if v and not k.startswith("plain_on")},
          "expected_launches": expect, "plain_on_cuda": plain,
          **({"capacity_factor": cfg.capacity_factor,
              "moe": moe_tally(rec)} if cfg.n_experts else {})})
    if cfg.n_experts and server:
        check_decode_groups(cfg, name, moe_tally(rec), len(step_ms))
    for k, n in expect.items():
        if counts[k] != n:
            raise AssertionError(f"{name}: {counts[k]} {k} launches, not "
                                 f"{n}")
    if plain:
        raise AssertionError(f"{name}: plain versions ran on CUDA tensors")
    if last is not None and not torch.isfinite(last).all():
        raise AssertionError(f"{name}: decode logits are not finite")
    del params, last
    if server:
        del srv
    gc.collect()
    torch.cuda.empty_cache()

    # ---- decode ≡ full forward on fresh f32 weights
    cfg32 = dataclasses.replace(base, n_layers=f32_depth, dtype="float32")
    # the f32 weights are drawn from seed 0, as the bf16 ones were
    g.manual_seed(0)  # lint: disable=KEY-REUSE
    p32 = M.init_params(cfg32, g)
    p_tok, nxt = tokens_of_len(F32_PROMPT), tokens_of_len(1, 1)
    img = img_of(1) if n_img else None
    max32 = n_img + F32_PROMPT + 2
    with layers.record_moe() as rec:
        decode_vs_forward(torch, dropless(cfg32), p32, f"{name} (f32, "
                          f"{f32_depth} layers)", p_tok, nxt, max32, 0,
                          DECODE_TOL_F32, separates=True, img=img)
    if drops_of(rec):
        raise AssertionError(f"{name} (f32, dropless): {drops_of(rec)} "
                             "assignments dropped")
    del p32
    gc.collect()
    torch.cuda.empty_cache()
    return {name: counts}


SERVICE_SEED = 7


def service_phase(torch, dev, card, cfg, params):
    """FedPFTService on granite-3-2b: 4 clients' extraction traffic (the
    smoke's 10-class inputs binned to tokens, lengths 128 … 512), the
    round closed through a warmed program cache, then inference of the
    test inputs interleaved with their round-2 extraction.  The served
    head must be bitwise the offline ``FedSession.run`` head; each label
    the head's argmax on its request's own features; the accuracy within
    0.08 of the centralized head's (tests/test_system.py:70)."""
    import dataclasses

    import numpy as np

    from repro_torch import data as D
    from repro_torch.core import fedpft as FP
    from repro_torch.core import gmm as G
    from repro_torch.core import head as H
    from repro_torch.fl import api as A
    from repro_torch.fl import ingest as IG
    from repro_torch.kernels import ops
    from repro_torch.launch.aot_cache import ProgramCache
    from repro_torch.serve.service import FedPFTService, ServiceConfig

    def check(cond, what):
        if not cond:
            raise AssertionError(f"service: {what}")

    dcfg = D.DatasetConfig(n_classes=10, n_per_class=100, input_dim=512,
                           class_sep=3.0)
    x, y = D.make_dataset(dcfg)
    xt, yt = D.make_dataset(dataclasses.replace(dcfg, n_per_class=25),
                            split=1)
    tok, tok_t = tokens_of(np, x), tokens_of(np, xt)
    rng = np.random.default_rng(0)
    lens = rng.integers(128, 513, size=len(tok))
    lens_t = rng.integers(128, 513, size=len(tok_t))

    def session():
        return A.FedSession(
            n_classes=10, summarizer=A.GMMSummarizer(G.GMMConfig()),
            ingest=IG.IngestConfig(capacity=64, chunk_size=8),
            program_cache=ProgramCache())
    svc = FedPFTService(cfg, params, session(),
                        ServiceConfig(n_slots=16, max_seq=512))
    parts = D.iid_shards(len(y), 4)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    reqs = [[svc.submit_extract(tok[j, :lens[j]]) for j in p]
            for p in parts]
    svc.drain()
    t_extract = time.perf_counter() - t0
    datasets = [(torch.from_numpy(np.stack([r.feats for r in rr])).to(dev),
                 torch.from_numpy(y[p]).to(dev))
                for rr, p in zip(reqs, parts)]
    warm = svc.warmup(d=cfg.d_model)
    verdicts = []
    for i, (f, yy) in enumerate(datasets):
        msg = svc.session.client_update(
            f, yy, i, generator=A.round_generator(SERVICE_SEED, 1 + i, dev),
            device=dev)
        verdicts.append(svc.submit_update(i, msg))
    cache = svc.session.program_cache
    misses0 = cache.misses
    t0 = time.perf_counter()
    res = svc.close_round(seed=SERVICE_SEED)
    torch.cuda.synchronize()
    t_close = time.perf_counter() - t0
    close_misses = cache.misses - misses0
    # round 2: inference of the test inputs interleaved with their
    # extraction
    inf, ext = [], []
    for j in range(len(tok_t)):
        inf.append(svc.submit_infer(tok_t[j, :lens_t[j]]))
        ext.append(svc.submit_extract(tok_t[j, :lens_t[j]]))
    svc.drain()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    stats = svc.stats()

    off = session().run(datasets, seed=SERVICE_SEED)
    bitwise = all(torch.equal(res.model[k], off.model[k])
                  for k in res.model)
    labels = np.asarray([r.label for r in inf])
    acc = float((labels == yt).mean())
    feats_t = torch.from_numpy(np.stack([r.feats for r in ext])).to(dev)
    yt_dev = torch.from_numpy(yt).to(dev)
    head_c, _ = FP.centralized_baseline(datasets, 10, FP.FedPFTConfig(),
                                        seed=0)
    acc_c = float(H.accuracy(head_c, feats_t, yt_dev))
    # each label against the head on its request's own features, the
    # request alone (a label may differ only where the head's top-2 gap
    # is within rounding of the two feature paths)
    own = {"checked": 0, "equal": 0, "near_ties": 0}
    t0 = time.perf_counter()
    for r in inf:
        L = r.tokens.shape[0]
        f = svc._feats(params, torch.from_numpy(r.tokens)[None].to(dev),
                       torch.tensor([L], device=dev))
        lg = H.head_logits(svc.head, f)[0]
        top2 = torch.topk(lg, 2).values
        own["checked"] += 1
        if int(torch.argmax(lg)) == r.label:
            own["equal"] += 1
        elif float(top2[0] - top2[1]) < 1e-2 * (1 + float(top2[0].abs())):
            own["near_ties"] += 1
        else:
            raise AssertionError(f"service: request {r.rid} label "
                                 f"{r.label} is not the head's argmax on "
                                 "its own features")
    own["s"] = time.perf_counter() - t0
    plain = sum(v for k, v in counts.items() if k.startswith("plain_on"))
    emit({"phase": "service", "model": cfg.name, "card": card,
          "n_slots": 16, "max_seq": 512, "n_clients": 4,
          "extract_requests": len(tok) + len(tok_t),
          "infer_requests": len(tok_t), "extract_round1_s": t_extract,
          "close_round_s": t_close, "close_round_cache_misses": close_misses,
          "warmup": warm, "verdicts": verdicts,
          "bitwise_offline_head": bitwise, "acc": acc,
          "acc_centralized": acc_c, "own_feature_labels": own,
          "stats": {k: v for k, v in stats.items() if k != "ingest"},
          "launches": {k: v for k, v in counts.items()
                       if v and not k.startswith("plain_on")},
          "plain_on_cuda": plain})
    check(all(v == "admitted" for v in verdicts), f"verdicts {verdicts}")
    check(close_misses == 0, f"close_round missed the cache {close_misses} "
          "times")
    check(bitwise, "the served head is not bitwise the offline head")
    check(acc >= acc_c - 0.08, f"acc {acc} < centralized {acc_c} − 0.08")
    check(acc_c > 0.5, f"centralized acc {acc_c} ≤ 0.5: the features lost "
          "the class signal")
    check(counts["flash_attention"] > 0 and counts["estep_fused"] > 0,
          f"kernels not launched: {counts}")
    check(plain == 0, "plain versions ran on CUDA tensors")
    check(stats["feature_compiles"] <= 3, f"{stats['feature_compiles']} "
          "feature shapes for buckets 128, 256, 512")
    return {"granite-3-2b/service": counts}


GIB = 2 ** 30
# the full_cov server phase's peak allocation above its start: the stack's
# factors are 40 × 1280² f32 = 0.26 GB; a per-draw gather would be 53.7 GB
FULL_COV_SERVER_BYTES = 2 * GIB


def measured(torch, ops, fn):
    """(fn(), wall s, launch counts, peak allocation above the start),
    the counts zeroed and the peak reset just before ``fn``."""
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    m0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return out, dt, ops.launch_counts(), torch.cuda.max_memory_allocated() - m0


def launch_fields(counts) -> dict:
    plain = sum(v for k, v in counts.items() if k.startswith("plain_on"))
    return {"estep_fused": counts["estep_fused"], "estep": counts["estep"],
            "plain_on_cuda": plain}


def slice_paths(torch, dev, card, kept):
    """Full-covariance FedPFT, DP-FedPFT, Chain, the streamed and pooled
    servers, the baselines, and Theorem 6.1 with the reconstruction
    attack, on hubert-xlarge's full-depth features: 4 iid clients of
    1000 × 1280, 1000 test rows, 10 classes.  Returns each path's launch
    counts."""
    import numpy as np

    from repro_torch import data as D
    from repro_torch.core import dp as DP
    from repro_torch.core import fedpft as FP
    from repro_torch.core import gmm as G
    from repro_torch.core import head as H
    from repro_torch.core import reconstruction as RA
    from repro_torch.core import theory as T
    from repro_torch.fl import api as A
    from repro_torch.fl import baselines as B
    from repro_torch.kernels import ops

    feats, feats_t, y, yt = (kept[k] for k in ("feats", "feats_t", "y",
                                               "yt"))
    d, C = int(feats.shape[1]), 10
    clients = [(feats[p], y[p]) for p in D.iid_shards(len(y), 4)]
    g_eval = torch.Generator(device=dev)
    g_eval.manual_seed(1)
    out = {}

    def central(cfg):
        head_c, _ = FP.centralized_baseline(clients, C, cfg, seed=0)
        ft = FP.maybe_normalize(feats_t, cfg)
        return float(H.accuracy(head_c, ft, yt)), ft

    def payload(messages):
        return sum(len(m.payload) for m in messages)

    def gmm_bytes(messages, cov_type, K):
        return sum(G.comm_bytes(cov_type, d, K, len(m.header.present))
                   for m in messages)

    def check(cond, what):
        if not cond:
            raise AssertionError(what)

    # ---- full_cov: K = 1 full covariance, normalized features, Star, fused
    cfg = FP.FedPFTConfig(gmm=G.GMMConfig(1, "full"), normalize_features=True)
    sess = FP.session_for(C, cfg)
    res, dt, counts, peak = measured(torch, ops,
                                     lambda: sess.run(clients, seed=0))
    acc_c, ft_n = central(cfg)
    acc = float(H.accuracy(res.model, ft_n, yt))
    _, server_s, _, server_peak = measured(
        torch, ops, lambda: sess.server_aggregate(
            res.messages, generator=g_eval, device=dev))
    comm, pay = res.info["comm_bytes"], payload(res.messages)
    want = gmm_bytes(res.messages, "full", 1)
    emit({"phase": "full_cov", "card": card, "phase_s": dt,
          "round_phase_s": res.info["phase_s"], "acc": acc,
          "acc_centralized": acc_c, "comm_bytes": comm, "payload_bytes": pay,
          "expected_bytes": want,
          "all_classes_everywhere": want == 4 * 10 * (1 + d + d * (d + 1)
                                                      // 2) * 2,
          "launches": launch_fields(counts), "peak_bytes": peak,
          "server_s": server_s, "server_peak_above_start": server_peak})
    check(comm == pay == want, f"full_cov: comm {comm}, payload {pay}, "
          f"formula {want}")
    check(acc >= acc_c - 0.08, f"full_cov: acc {acc} < {acc_c} − 0.08")
    check(server_peak < FULL_COV_SERVER_BYTES,
          f"full_cov: server peak {server_peak} B above its start")
    check(launch_fields(counts)["plain_on_cuda"] == 0, "full_cov: plain ran")
    check(torch.isfinite(res.model["w"]).all(), "full_cov: head not finite")
    out["hubert-xlarge/full_cov"] = counts
    f0, y0 = clients[0]
    for part, fn in (
            ("full_cov_client_fit_and_encode", lambda: sess.encode(
                *sess.client_summary(f0, y0, 0, generator=g_eval,
                                     device=dev))),
            ("full_cov_server", lambda: sess.server_aggregate(
                res.messages, generator=g_eval, device=dev))):
        emit({"phase": "profile", "model": "hubert-xlarge", "part": part,
              "card": card, **device_profile(torch, fn)})

    # ---- dp: the same config through DP-FedPFT (Theorem 4.1)
    dp_cfg = DP.DPConfig(epsilon=1.0, delta=1e-3)
    (head, info), dt, counts, peak = measured(
        torch, ops, lambda: DP.run_dp_fedpft(clients, C, cfg, dp_cfg, seed=0))
    n_c = np.concatenate([m.counts for m in info["messages"]])
    sigma = DP.noise_scale(np.maximum(n_c[n_c > 0], 1).astype(np.float64),
                           dp_cfg.epsilon, dp_cfg.delta)
    comm, pay = info["comm_bytes"], payload(info["messages"])
    want = gmm_bytes(info["messages"], "full", 1)
    finite = all(bool(torch.isfinite(v).all()) for v in head.values())
    emit({"phase": "dp", "card": card, "phase_s": dt,
          "acc": float(H.accuracy(head, ft_n, yt)), "acc_centralized": acc_c,
          "sigma_per_class": [float(sigma.min()), float(sigma.max())],
          "class_counts": [int(n_c.min()), int(n_c.max())],
          "comm_bytes": comm, "payload_bytes": pay, "expected_bytes": want,
          "head_finite": finite, "launches": launch_fields(counts),
          "peak_bytes": peak})
    check(finite, "dp: head not finite")
    check(comm == pay == want, f"dp: comm {comm}, payload {pay}, {want}")
    check(launch_fields(counts)["plain_on_cuda"] == 0, "dp: plain ran")
    out["hubert-xlarge/dp"] = counts

    # ---- chain: client 1 → 2 → 3 → 4, diag K = 10
    gcfg = G.GMMConfig()
    acc_c, _ = central(FP.FedPFTConfig())
    sess = A.FedSession(n_classes=C, topology=A.Chain(),
                        summarizer=A.GMMSummarizer(gcfg))
    res, dt, counts, peak = measured(torch, ops,
                                     lambda: sess.run(clients, seed=0))
    accs = [float(H.accuracy(i["head"], feats_t, yt))
            for i in res.info["per_client"]]
    comm, pay = res.info["comm_bytes"], payload(res.messages)
    # one batched EM a client: n_iter E-steps and the final log-likelihood
    want_estep = len(clients) * (gcfg.n_iter + 1)
    emit({"phase": "chain", "card": card, "phase_s": dt, "acc": accs[-1],
          "acc_per_client": accs, "acc_centralized": acc_c,
          "n_train": [i["n_train"] for i in res.info["per_client"]],
          "comm_bytes": comm, "payload_bytes": pay,
          "launches": launch_fields(counts),
          "expected_estep_fused": want_estep, "peak_bytes": peak})
    check(accs[-1] >= acc_c - 0.08, f"chain: acc {accs[-1]} < {acc_c} − 0.08")
    check(comm == pay, f"chain: comm {comm} != payload {pay}")
    check(counts["estep_fused"] == want_estep and counts["estep"] == 0,
          f"chain: {counts['estep_fused']} E-steps, not {want_estep}")
    check(launch_fields(counts)["plain_on_cuda"] == 0, "chain: plain ran")
    out["hubert-xlarge/chain"] = counts

    # ---- synthesis: the streamed and pooled servers, diag K = 10
    pooled = None
    for mode in ("streamed", "pooled"):
        sess = A.FedSession(n_classes=C, summarizer=A.GMMSummarizer(gcfg),
                            synthesis=mode)
        res, dt, counts, peak = measured(torch, ops,
                                         lambda: sess.run(clients, seed=0))
        acc = float(H.accuracy(res.model, feats_t, yt))
        comm, pay = res.info["comm_bytes"], payload(res.messages)
        emit({"phase": "synthesis", "mode": mode, "card": card,
              "phase_s": dt, "round_phase_s": res.info["phase_s"],
              "acc": acc, "acc_centralized": acc_c, "comm_bytes": comm,
              "payload_bytes": pay, "fused_comm_bytes": kept["comm_fused"],
              "draws": res.info["synthesis_plans"][0].padded_draws,
              "launches": launch_fields(counts), "peak_bytes": peak})
        check(acc >= acc_c - 0.08, f"{mode}: acc {acc} < {acc_c} − 0.08")
        check(comm == pay == kept["comm_fused"], f"{mode}: comm {comm}, "
              f"payload {pay}, fused {kept['comm_fused']}")
        check(counts["estep_fused"] == want_estep,
              f"{mode}: {counts['estep_fused']} E-steps")
        check(launch_fields(counts)["plain_on_cuda"] == 0, f"{mode}: plain")
        check(res.info["synthesis"] == mode, f"{mode}: ran {res.info}")
        out[f"hubert-xlarge/{mode}"] = counts
        pooled = res

    # ---- baselines: one-shot heads (AVG / Ensemble / FedBE), FedAvg, Yogi;
    # at d = 1280: 4 × (10 × 1280 + 10) × 2 = 102,480 bytes one-shot and
    # 2 × 4 × 25,620 × 10 = 2,049,600 over ten rounds
    want = 4 * B.head_comm_bytes(d, C)
    for agg in ("avg", "ensemble", "fedbe"):
        sess = A.FedSession(n_classes=C, summarizer=A.HeadSummarizer(),
                            aggregate=agg)
        res, dt, counts, peak = measured(torch, ops,
                                         lambda: sess.run(clients, seed=0))
        heads = [res.model] if agg == "avg" else res.model
        acc = float((B.ensemble_predict(heads, feats_t) == yt).float()
                    .mean())
        comm, pay = res.info["comm_bytes"], payload(res.messages)
        emit({"phase": "baselines", "method": agg, "card": card,
              "phase_s": dt, "acc": acc, "acc_centralized": acc_c,
              "n_heads": len(heads), "comm_bytes": comm,
              "payload_bytes": pay, "expected_bytes": want,
              "launches": launch_fields(counts), "peak_bytes": peak})
        check(comm == pay == want, f"{agg}: comm {comm}, payload {pay}")
        check(launch_fields(counts)["plain_on_cuda"] == 0, f"{agg}: plain")
    mcfg = B.MultiRoundConfig()
    for server in ("avg", "yogi"):
        (head, info), dt, counts, peak = measured(
            torch, ops, lambda: B.fedavg(
                clients, C, B.MultiRoundConfig(server=server), seed=0))
        want_mr = 2 * 4 * B.head_comm_bytes(d, C) * mcfg.rounds
        emit({"phase": "baselines", "method": f"fedavg/{server}",
              "card": card, "phase_s": dt,
              "acc": float(H.accuracy(head, feats_t, yt)),
              "acc_centralized": acc_c, "comm_bytes": info["comm_bytes"],
              "expected_bytes": want_mr, "launches": launch_fields(counts),
              "peak_bytes": peak})
        check(info["comm_bytes"] == want_mr,
              f"fedavg/{server}: comm {info['comm_bytes']}")

    # ---- theory_attack: Theorem 6.1 on the pooled run; the inversion
    # attack fitted on the test split, aimed at the train split's inputs
    def theory_attack():
        sf = pooled.info["synthetic_feats"]
        sl = pooled.info["synthetic_labels"]
        loss_c, _ = H.classwise_01_loss(pooled.model, sf, sl, C)
        g = torch.Generator(device=dev)
        g.manual_seed(0)
        H_c = torch.stack([T.entropy_knn(feats[y == c], generator=g)
                           for c in range(C)])
        n = torch.tensor(np.stack([m.counts for m in pooled.messages]),
                         dtype=torch.float32, device=dev)
        ll = torch.tensor([m.logliks for m in pooled.messages], device=dev)
        L_EM = (n * ll).sum(0) / n.sum(0).clamp_min(1.0)
        rhs = float(T.theorem61_bound(loss_c, H_c, L_EM, n.sum(0)))
        lhs = 1.0 - float(H.accuracy(pooled.model, feats, y))
        acfg = RA.AttackConfig()
        atk = RA.fit_inversion(feats_t, torch.from_numpy(kept["xt"]), acfg)
        target = torch.from_numpy(kept["x"])
        return (lhs, rhs, H_c, L_EM,
                RA.evaluate_attack(atk, feats, target, acfg),
                RA.evaluate_attack(atk, sf, target, acfg))
    (lhs, rhs, H_c, L_EM, m_raw, m_gmm), dt, counts, peak = measured(
        torch, ops, theory_attack)
    numbers = [lhs, rhs, *m_raw.values(), *m_gmm.values()]
    emit({"phase": "theory_attack", "card": card, "phase_s": dt,
          "lhs": lhs, "rhs": rhs, "entropy_knn": [float(v) for v in H_c],
          "L_EM": [float(v) for v in L_EM], "attack_raw": m_raw,
          "attack_gmm": m_gmm, "launches": launch_fields(counts),
          "peak_bytes": peak})
    check(all(math.isfinite(v) for v in numbers),
          "theory_attack: a non-finite number")
    return out


def shift_methods(torch, dev, src, dst, test, C):
    """benchmarks/shifts.py's Table 2 row for one two-client shift:
    (accuracy, bytes) of Centralized, Ensemble, AVG, KD and FedPFT."""
    from repro_torch.core import decentralized as DC
    from repro_torch.core import fedpft as FP
    from repro_torch.core import head as H
    from repro_torch.fl import baselines as B
    (fs, ys), (fd, yd) = src, dst
    ft, yt = test
    d = int(fs.shape[1])
    cfg = FP.FedPFTConfig()
    g = torch.Generator(device=dev)
    g.manual_seed(1)

    def acc(head):
        return float(H.accuracy(head, ft, yt))

    head_c, info_c = FP.centralized_baseline([src, dst], C, cfg, seed=0)
    out = {"centralized": (acc(head_c), info_c["comm_bytes"])}
    h_src, h_dst = (B.local_train(H.init_head(d, C, generator=g, device=dev),
                                  f, y, C, n_steps=200, lr=3e-3, generator=g)
                    for f, y in (src, dst))
    hb = B.head_comm_bytes(d, C)
    out["ensemble"] = (float((B.ensemble_predict([h_src, h_dst], ft) == yt)
                             .float().mean()), hb)
    out["avg"] = (acc(B.avg_heads([h_src, h_dst])), hb)
    out["kd"] = (acc(B.kd_transfer(h_src, h_dst, fd, yd, C, n_steps=200,
                                   generator=g)), hb)
    msgs, infos = DC.run_chain([src, dst], C, cfg, seed=0)
    out["fedpft"] = (acc(infos[-1]["head"]), msgs[0].comm_bytes)
    return out


def slice6_paths(torch, dev, card, kept):
    """The §5.3 shifts, streaming ingest, the round-program cache and a
    chaos round, on hubert-xlarge's full-depth features (the covariate and
    task shifts through the encoder on their own inputs).  Returns each
    path's launch counts."""
    import dataclasses

    import numpy as np

    from repro_torch import data as D
    from repro_torch.core import gmm as G
    from repro_torch.core import head as H
    from repro_torch.fl import api as A
    from repro_torch.fl import faults as FJ
    from repro_torch.fl import ingest as IG
    from repro_torch.fl import resilience as RS
    from repro_torch.kernels import ops
    from repro_torch.launch import aot_cache as AC

    feats, feats_t, y, yt = (kept[k] for k in ("feats", "feats_t", "y",
                                               "yt"))
    features_of = kept["features_of"]
    C = 10
    out = {}

    def check(cond, what):
        if not cond:
            raise AssertionError(what)

    def byte_law(acct):
        return sum(acct[k] for k in (
            "admitted_bytes", "late_bytes", "duplicate_bytes",
            "over_cap_bytes", "quarantined_bytes", "closed_bytes")) \
            == acct["sent_bytes"]

    def same_head(a, b):
        return all(torch.equal(a[k], b[k]) for k in ("w", "b"))

    def on_card(x, labels):
        return features_of(x), torch.from_numpy(np.asarray(labels)).to(dev)

    # ---- shifts: Table 2's three two-client shifts
    def shifts():
        rows = {}
        y_np = y.cpu().numpy()
        src, dst = D.disjoint_label_split(y_np)
        rows["label"] = shift_methods(
            torch, dev, (feats[src], y[src]), (feats[dst], y[dst]),
            (feats_t, yt), C)
        cov_cfg = D.DatasetConfig(n_classes=C, n_per_class=200,
                                  input_dim=512, class_sep=3.0, n_domains=2)
        (xa, ya), (xb, yb) = D.covariate_shift_pair(cov_cfg)
        test_cfg = dataclasses.replace(cov_cfg, n_per_class=50)
        tests = [D.make_dataset(test_cfg, domain=k, split=1) for k in (0, 1)]
        xt = np.concatenate([t[0] for t in tests])
        ytc = np.concatenate([t[1] for t in tests])
        rows["covariate"] = shift_methods(
            torch, dev, on_card(xa, ya), on_card(xb, yb), on_card(xt, ytc),
            C)
        ta = D.DatasetConfig(n_classes=5, n_per_class=200, input_dim=512,
                             class_sep=3.0)
        tb = dataclasses.replace(ta, seed=1)
        (xa, ya), (xb, yb), C_ab = D.task_shift_pair(ta, tb)
        xta, yta = D.make_dataset(dataclasses.replace(ta, n_per_class=50),
                                  split=1)
        xtb, ytb = D.make_dataset(dataclasses.replace(
            tb, n_per_class=50, seed=tb.seed + 7919), split=1)
        rows["task"] = shift_methods(
            torch, dev, on_card(xa, ya), on_card(xb, yb),
            on_card(np.concatenate([xta, xtb]),
                    np.concatenate([yta, ytb + ta.n_classes])), C_ab)
        return rows

    rows, dt, counts, peak = measured(torch, ops, shifts)
    emit({"phase": "shifts", "card": card, "phase_s": dt,
          "rows": {s: {m: {"acc": a, "bytes": b} for m, (a, b) in r.items()}
                   for s, r in rows.items()},
          "launches": {**launch_fields(counts),
                       "flash_attention": counts["flash_attention"]},
          "peak_bytes": peak})
    for shift, r in rows.items():
        check(r["fedpft"][0] >= r["centralized"][0] - 0.08,
              f"shifts/{shift}: FedPFT {r['fedpft'][0]} < centralized "
              f"{r['centralized'][0]} − 0.08")
    check(counts["flash_attention"] > 0, "shifts: no flash launch")
    check(launch_fields(counts)["plain_on_cuda"] == 0, "shifts: plain ran")
    out["hubert-xlarge/shifts"] = counts

    # ---- ingest: the streaming round against the fused Star round
    gcfg = G.GMMConfig()
    clients = [(feats[p], y[p]) for p in D.iid_shards(len(y), 4)]
    clients12 = [(feats[p], y[p]) for p in D.iid_shards(len(y), 12)]

    def session(**kw):
        return A.FedSession(n_classes=C, summarizer=A.GMMSummarizer(gcfg),
                            **kw)

    icfg = IG.IngestConfig(capacity=64, chunk_size=2)
    fused = session().run(clients, seed=0)

    def ingest():
        return (session(ingest=icfg).run(clients, seed=0),
                session(ingest=icfg).run(clients12, seed=0))
    (stream, stream12), dt, counts, peak = measured(torch, ops, ingest)
    acct, acct12 = stream.info["ingest"], stream12.info["ingest"]
    state_bytes = IG.IngestState.empty(C, "diag", gcfg.n_components,
                                       int(feats.shape[1]), 64).nbytes
    msg_bytes = max(IG.IngestBroker._message_bytes(m)
                    for m in fused.messages)
    emit({"phase": "ingest", "card": card, "phase_s": dt,
          "bitwise_fused": same_head(stream.model, fused.model),
          "accounting": acct, "accounting_12": acct12,
          "state_bytes": state_bytes, "pending_message_bytes": msg_bytes,
          "acc": float(H.accuracy(stream.model, feats_t, yt)),
          "acc_fused": float(H.accuracy(fused.model, feats_t, yt)),
          "acc_12": float(H.accuracy(stream12.model, feats_t, yt)),
          "launches": launch_fields(counts), "peak_bytes": peak})
    check(same_head(stream.model, fused.model),
          "ingest: the streaming head is not bitwise the fused head")
    check(byte_law(acct) and byte_law(acct12), "ingest: byte law broken")
    check(acct["sent_bytes"] == fused.info["comm_bytes"],
          "ingest: sent bytes ≠ the fused round's bytes")
    check(acct["slots_evicted"] == 0 and acct["slots_retained"] == 40,
          f"ingest: {acct['slots_retained']} slots kept")
    check(acct12["slots_seen"] == 120 and acct12["slots_evicted"] == 56,
          f"ingest: {acct12['slots_evicted']} of {acct12['slots_seen']} "
          "slots evicted, not 56 of 120")
    check(acct12["peak_resident_bytes"]
          <= state_bytes + icfg.chunk_size * msg_bytes,
          f"ingest: peak {acct12['peak_resident_bytes']} B over the state "
          "and one pending chunk")
    check(launch_fields(counts)["plain_on_cuda"] == 0, "ingest: plain ran")
    out["hubert-xlarge/ingest"] = counts

    # ---- program_cache: captured round programs against the eager server
    def program_cache():
        cache = AC.ProgramCache()
        cached = session(program_cache=cache)
        eager = session()
        msgs = fused.messages
        rows = {}
        for M in (3, 4):
            # replay == eager: every run draws the server stream of seed 0
            gen = A.round_generator(0, 0, dev)  # lint: disable=KEY-REUSE
            m0 = torch.cuda.memory_allocated()
            res = cached.server_aggregate(msgs[:M], generator=gen,
                                          device=dev)
            rows[M] = dict(res.info["compile"],
                           allocated_delta=torch.cuda.memory_allocated()
                           - m0, model=res.model)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = eager.server_aggregate(
            msgs[:3], generator=A.round_generator(0, 0, dev),  # lint: disable=KEY-REUSE
            device=dev)
        torch.cuda.synchronize()
        eager_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        replay = cached.server_aggregate(
            msgs[:3], generator=A.round_generator(0, 0, dev),  # lint: disable=KEY-REUSE
            device=dev)
        torch.cuda.synchronize()
        replay_s = time.perf_counter() - t0
        entry = cache.entries()[0]
        warm = cache.warmup(AC.serving_grid(64, C, gcfg.n_components,
                                            int(feats.shape[1])),
                            session().head)
        before = cache.snapshot()
        streamed = session(ingest=icfg, program_cache=cache).run(clients,
                                                                 seed=0)
        return (rows, want, replay, eager_s, replay_s, entry, warm,
                cache.delta(before), streamed, cache)
    (rows, want, replay, eager_s, replay_s, entry, warm, delta, streamed,
     cache), dt, counts, peak = measured(torch, ops, program_cache)
    stats = cache.stats()
    slot_entry = streamed.info["compile"]
    emit({"phase": "program_cache", "card": card, "phase_s": dt,
          "rounds": {M: {k: v for k, v in r.items() if k != "model"}
                     for M, r in rows.items()},
          "capture_s": entry.compile_us / 1e6,
          "entry_memory_bytes": entry.memory_bytes,
          "eager_server_s": eager_s, "replay_server_s": replay_s,
          "replay_run_s": replay.info["compile"]["run_us"] / 1e6,
          "speedup": eager_s / replay_s,
          "bitwise_eager_m3": same_head(rows[3]["model"], want.model),
          "bitwise_replay": same_head(replay.model, want.model),
          "warm_streaming": {"hit": slot_entry["hit"],
                             "run_s": slot_entry["run_us"] / 1e6,
                             "bitwise_eager_streaming": same_head(
                                 streamed.model, stream.model)},
          "warmup_stats": warm, "delta": delta, "stats": stats,
          "cache_memory_bytes": cache.memory_bytes,
          "cache_max_bytes": cache.max_bytes,
          "launches": launch_fields(counts), "peak_bytes": peak})
    check(not rows[3]["hit"] and rows[4]["hit"] and rows[3]["aot"],
          f"program_cache: M = 3 then 4 gave hits {rows[3]['hit']}, "
          f"{rows[4]['hit']}")
    check(rows[4]["cache"]["misses"] == 1 and rows[4]["cache"]["compiles"]
          == 1 and rows[4]["cache"]["hits"] == 1,
          f"program_cache: {rows[4]['cache']} after M = 3, 4")
    check(same_head(rows[3]["model"], want.model)
          and same_head(replay.model, want.model),
          "program_cache: the cached head is not bitwise the eager head")
    check(same_head(streamed.model, stream.model),
          "program_cache: the cached streaming head is not bitwise the "
          "eager streaming head")
    check(delta["compiles"] == 0 and slot_entry["hit"],
          f"program_cache: the warm streaming round moved {delta}")
    check(stats["jit_fallbacks"] == 0,
          f"program_cache: {stats['jit_fallbacks']} capture fallbacks")
    check(0 < cache.memory_bytes <= cache.max_bytes,
          f"program_cache: entries hold {cache.memory_bytes} B, bound "
          f"{cache.max_bytes} B")
    check(replay_s < eager_s, f"program_cache: replay {replay_s} s not "
          f"under the eager server's {eager_s} s")
    check(launch_fields(counts)["plain_on_cuda"] == 0,
          "program_cache: plain ran")
    out["hubert-xlarge/program_cache"] = counts

    # ---- chaos: the 12 clients under a fault plan; partial ≡ survivors
    plan = FJ.FaultPlan(seed=11, drop=0.2, corrupt=0.15, straggle=0.2,
                        straggle_delay_s=100.0, transient=0.2)
    ccfg = IG.IngestConfig(deadline_s=5.0)
    chaos_sess = session(ingest=ccfg,
                         resilience=RS.ResilienceConfig(max_retries=2))

    def chaos():
        return chaos_sess.run(clients12, seed=0, faults=plan)
    res, dt, counts, peak = measured(torch, ops, chaos)
    faults, acct = res.info["faults"], res.info["ingest"]
    surv = faults["admitted_clients"]
    broker = IG.IngestBroker(ccfg, C, clock=lambda: 0.0)
    for i in surv:
        f, yy = clients12[i]
        broker.submit(i, chaos_sess.client_update(
            f, yy, i, generator=A.round_generator(0, 1 + i, dev),
            device=dev))
    off = chaos_sess.aggregate_from_broker(broker, seed=0)
    emit({"phase": "chaos", "card": card, "phase_s": dt,
          "faults": faults, "accounting": acct,
          "bitwise_offline_survivors": same_head(res.model, off.model),
          "acc": float(H.accuracy(res.model, feats_t, yt)),
          "launches": launch_fields(counts), "peak_bytes": peak})
    check(0 < len(surv) < 12, f"chaos: {len(surv)} of 12 admitted")
    check(byte_law(acct), "chaos: byte law broken")
    check(faults["degraded"], "chaos: round not marked degraded")
    check(same_head(res.model, off.model),
          "chaos: the partial head is not bitwise the offline survivors'")
    check(launch_fields(counts)["plain_on_cuda"] == 0, "chaos: plain ran")
    out["hubert-xlarge/chaos"] = counts
    return out


def mesh_phase(torch, dev, card, kept):
    """The one-shot round as a collective on one NCCL rank: hubert-xlarge's
    features (4 iid clients × 1000 × 1280, 10 classes) through
    ``FedSession.run_sharded`` (diag K = 10, bf16 wire, fused head), the
    wire all-gather held to Eqs. 9-11 exactly; then ``fedpft_dryrun`` at
    its defaults (16 clients × 1024 × 64, 8 classes, K 5, diag).  A failed
    NCCL start fails the phase.  Returns the launch counts."""
    import torch.distributed as dist

    from repro_torch import data as D
    from repro_torch.core import distributed as DF
    from repro_torch.core import fedpft as FP
    from repro_torch.core import gmm as G
    from repro_torch.core import head as H
    from repro_torch.fl import api as A
    from repro_torch.kernels import ops
    from repro_torch.launch import fedpft_dryrun as FD
    from repro_torch.launch import mesh as LM

    feats, feats_t, y, yt = (kept[k] for k in ("feats", "feats_t", "y",
                                               "yt"))
    C, K, d = 10, 10, int(feats.shape[1])
    parts = D.iid_shards(len(y), 4)
    clients = [(feats[p], y[p]) for p in parts]
    started = LM.ensure_process_group(dev)
    t0 = time.perf_counter()
    mesh = LM.make_sim_mesh(1, device=dev)
    init_s = time.perf_counter() - t0
    sess = A.FedSession(n_classes=C, summarizer=A.GMMSummarizer(
        G.GMMConfig(K, "diag")), shards=1)

    def round_():
        with DF.record_collectives() as tally:
            res = sess.run_sharded(torch.stack([f for f, _ in clients]),
                                   torch.stack([t for _, t in clients]),
                                   seed=0)
        return res, tally
    (res, tally), dt, counts, peak = measured(torch, ops, round_)
    head_c, _ = FP.centralized_baseline(clients, C, FP.FedPFTConfig(),
                                        seed=0)
    acc_c = float(H.accuracy(head_c, feats_t, yt))
    acc = float(H.accuracy(res.model, feats_t, yt))
    payload = sum(len(m.payload) for m in res.messages)
    want = DF.expected_wire_bytes("diag", d, K, C, len(clients))
    fd_rows, fd = FD.run(device=dev)
    # since ``measured`` zeroed them: the round, then fedpft_dryrun
    all_counts = ops.launch_counts()
    line = {"phase": "mesh", "card": card, "backend": dist.get_backend(),
            "world": dist.get_world_size(), "mesh": LM.axes_of(mesh),
            "group_init_s": init_s, "phase_s": dt,
            "round_phase_s": res.info["phase_s"], "acc": acc,
            "acc_centralized": acc_c, "comm_bytes": res.info["comm_bytes"],
            "payload_bytes": payload,
            "mesh_wire_bytes": res.info["mesh_wire_bytes"],
            "all_gather_wire_bytes": tally["by_tag"]["wire"],
            "all_gather_bytes_by_tag": tally["by_tag"],
            "expected_wire_bytes": want, "launches": launch_fields(counts),
            "peak_bytes": peak, "fedpft_dryrun": fd_rows,
            "fedpft_dryrun_ratio_wire": fd["ratio_wire"],
            "fedpft_dryrun_ratio_raw": fd["ratio_raw"],
            "phase_launches": launch_fields(all_counts)}
    emit(line)
    if started:
        dist.destroy_process_group()
    if not (acc > acc_c - 0.08 and res.info["comm_bytes"] == payload
            and res.info["mesh_wire_bytes"] == want
            and tally["by_tag"]["wire"] == want
            and counts["estep_fused"] > 0
            and launch_fields(counts)["plain_on_cuda"] == 0
            and fd["ratio_wire"] == 1.0 and fd["ratio_raw"] == 1.0
            and launch_fields(all_counts)["plain_on_cuda"] == 0
            and line["backend"] == "nccl"):
        raise AssertionError(f"mesh: {line}")
    return {"mesh": all_counts}


def analysis_phase(torch, dev, card, kept):
    """``repro_torch.analysis`` on the card, on hubert-xlarge's live
    features: (1) the lint over ``src/repro_torch`` and this script with
    its semantic rules on ``cuda`` — every source's launch plan checked at
    every probe (``analysis/pallas_rules.py``), no gating finding; (2)
    one features batch through flash, then the 4-client round (fused
    E-step, bf16 wire, fused head), all under ``sanitize(strict=True)``:
    nothing raises, both kernel wrappers' outputs are checked, and the
    head is bitwise the same round's run without the sanitizer; (3) four
    controls that must fire: a NaN in one E-step input row (named
    ``gmm_estep_fused``), an Inf in a flash input (named ``attention``), a
    replayed generator state (``KeyReuseError``), a plan above 227 KiB
    (CUDA-SMEM).  Returns the sanitized run's launch counts."""
    import collections

    from repro_torch import data as D
    from repro_torch.analysis import core as AN
    from repro_torch.analysis import pallas_rules as PR
    from repro_torch.analysis.sanitize import KeyReuseError, sanitize
    from repro_torch.core import gmm as G
    from repro_torch.fl import api as A
    from repro_torch.kernels import _build, ops

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent
    rules = AN._default_rules()
    launch = next(r for r in rules if isinstance(r, PR.LaunchContractRule))
    t0 = time.perf_counter()
    findings = AN.analyze_paths([str(root / "src" / "repro_torch"),
                                 str(root / "chip_smoke.py")], rules=rules,
                                semantic=True, device="cuda")
    lint_s = time.perf_counter() - t0
    gating = AN.gating(findings)
    by_rule = collections.Counter(
        f"{f.rule}:{f.severity}{':suppressed' if f.suppressed else ''}"
        for f in findings)
    n_probes = collections.Counter(p.source for p in PR.kernel_probes())

    # ---- one features batch and the 4-client round, sanitized
    feats, y, x = kept["feats"], kept["y"], kept["x"]
    clients = [(feats[p], y[p]) for p in D.iid_shards(len(y), 4)]
    sess = A.FedSession(n_classes=10, summarizer=A.GMMSummarizer(
        G.GMMConfig()))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = sess.run(clients, seed=0)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    ops.reset_launch_counts()
    with sanitize(strict=True) as st:
        t0 = time.perf_counter()
        batch_feats = kept["features_of"](x[:256])
        torch.cuda.synchronize()
        feats_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = sess.run(clients, seed=0)
        torch.cuda.synchronize()
        round_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    bitwise = all(torch.equal(res.model[k], plain.model[k])
                  for k in ("w", "b"))

    # ---- controls: each must fire
    fired = {}
    xe = feats[:512].float().contiguous().clone()
    mu = xe[:10].clone()
    var = torch.ones_like(mu)
    pi = torch.full((10,), 0.1, device=dev)
    xe[3] = float("nan")
    try:
        with sanitize(strict=True):
            ops.gmm_estep_fused(xe, mu, var, pi)
    except FloatingPointError as e:
        fired["nan_estep"] = str(e)
    q = torch.randn(1, 16, 64, 80, device=dev, dtype=torch.bfloat16)
    kv = q.clone()
    q[0, 3, 5, 7] = float("inf")
    try:
        with sanitize(strict=True):
            ops.attention(q, kv, kv, causal=False)
    except FloatingPointError as e:
        fired["inf_flash"] = str(e)
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    try:
        with sanitize(strict=True):
            saved = g.get_state()
            torch.randn(4, device=dev, generator=g)
            g.set_state(saved)
            # the control replays a consumed state on purpose
            torch.randn(4, device=dev, generator=g)  # lint: disable=KEY-REUSE
    except KeyReuseError as e:
        fired["replay"] = str(e)
    probe = next(p for p in PR.kernel_probes()
                 if p.name == "flash_bwd[d192]")
    inst = max(PR.plan_probe(probe, "cuda"),
               key=lambda i: i["static_smem"] + i["dyn_smem"])
    over = dict(inst, dyn_smem=PR.SMEM_LIMIT_BYTES + 1 - inst["static_smem"])
    smem_rules = [r for r, _, _ in PR.check_launch(over, over)]
    if "CUDA-SMEM" in smem_rules:
        fired["smem_plan"] = f"{inst['kernel']} at {over['dyn_smem']} B"
    torch.cuda.synchronize()

    line = {"phase": "analysis", "card": card, "lint_s": lint_s,
            "findings": len(findings), "gating": len(gating),
            "findings_by_rule": dict(sorted(by_rule.items())),
            "sources": {s: dict(launch.report.get(s, {}),
                                probes_expected=n_probes[s])
                        for s in _build.SOURCES},
            "sanitized": {"n_checked": st.n_checked,
                          "n_values": st.n_values,
                          "kernel_checks": st.kernel_checks,
                          "n_generators": st.n_generators,
                          "n_errors": st.n_errors,
                          "features_batch_s": feats_s, "round_s": round_s,
                          "round_plain_s": plain_s,
                          "round_overhead": round_s / plain_s},
            "head_bitwise": bitwise, "controls": fired,
            "launches": launch_fields(counts),
            "flash_launches": counts["flash_attention"],
            "phase_s": time.perf_counter() - t_phase}
    emit(line)
    for f in gating:
        print(f.format(), file=sys.stderr)
    if gating:
        raise AssertionError(f"analysis: {len(gating)} gating findings")
    for s in _build.SOURCES:
        rep = launch.report.get(s, {})
        if rep.get("probes") != n_probes[s] or not rep.get("instances"):
            raise AssertionError(f"analysis: {s} was not checked at every "
                                 f"probe: {rep}")
    missing = {"nan_estep": "gmm_estep_fused", "inf_flash": "attention",
               "replay": "consumed", "smem_plan": ""}
    for k, word in missing.items():
        if k not in fired or word not in fired[k]:
            raise AssertionError(f"analysis: control {k} did not fire "
                                 f"({fired.get(k)})")
    if not (bitwise and st.n_errors == 0
            and st.kernel_checks.get("gmm_estep_fused", 0) >= 1
            and st.kernel_checks.get("attention", 0) >= 1
            and counts["flash_attention"] == 48
            and counts["estep_fused"] >= 1
            and launch_fields(counts)["plain_on_cuda"] == 0
            and bool(torch.isfinite(batch_feats).all())):
        raise AssertionError(f"analysis: {line}")
    return {"analysis": counts}


# the dryrun phase: every arch × shape pair's step at full width (depth
# cut, one shard's rows: launch/dryrun.py), one line each
DRYRUN_KERNELS = ("flash_attention", "flash_attention_bwd",
                  "attention_cached", "wkv6", "wkv6_bwd", "ssd", "ssd_bwd")


# flash's forward at a dry-run shape is held on its last query rows,
# against the plain attention over every key (the plain version's f32
# scores of all rows would not fit beside the step's tensors)
DRYRUN_Q_BLOCK = 128


def dryrun_kernel_checks(torch, dev, calls):
    """Every distinct kernel call of the dry run (``ops.record_calls`` over
    each pair's warm-up: its shapes, layouts, keywords and positions)
    replayed on fresh inputs in the call's own layouts
    (``checks.replay_inputs``) and held against its plain version on the
    same inputs, at the kernel phase's tolerances: flash's forward on the
    last ``DRYRUN_Q_BLOCK`` query rows of every row and head; with grad,
    the forward and dq, dk, dv (dO N(0, 1)) on the last batch row; cached
    attention whole (rows with no visible key exactly 0); wkv6 and ssd
    whole, and with grad their backwards on the last batch row, wkv6's du
    (a sum over the batch) whole against its direct formula.  ``calls``:
    [(pair, [ops.Call])].  Returns {kernel: calls held}."""
    from repro_torch.kernels import attention_cached as CA
    from repro_torch.kernels import checks, ref
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_attention_bwd as FAB
    from repro_torch.kernels import ssd as SSD
    from repro_torch.kernels import ssd_bwd as SSDB
    from repro_torch.kernels import wkv6 as WKV
    from repro_torch.kernels import wkv6_bwd as WKVB

    seen, held = {}, {k: 0 for k in DRYRUN_KERNELS}
    for pair, pair_calls in calls:
        for call in pair_calls:
            if not call.name.endswith("_bwd"):
                seen.setdefault(call.key, (pair, call))
    t0 = time.perf_counter()
    for i, (pair, call) in enumerate(seen.values()):
        g = torch.Generator(device=dev).manual_seed(1000 + i)
        args = checks.replay_inputs(call, g, dev)
        kw = dict(call.kw)
        bf16 = args[0].dtype == torch.bfloat16
        shape = dict(case=f"dryrun {pair}", shape=list(args[0].shape),
                     dtype=str(args[0].dtype), grad=call.grad, **kw)
        last = slice(args[0].shape[0] - 1, args[0].shape[0])
        if call.name == "attention":
            q, k, v = args
            tol = checks.FLASH_TOL_BF16 if bf16 else ATTN_TOL_F32
            if not call.grad:
                o = FA.flash_attention(q, k, v, **kw)
                Sq = q.shape[2]
                blk = slice(Sq - min(Sq, DRYRUN_Q_BLOCK), Sq)
                check_close(torch, "flash_attention", o[:, :, blk],
                            ref.attention_ref(q[:, :, blk], k, v, **kw),
                            tol, rows=f"queries {blk.start}-{Sq - 1}",
                            **shape)
                held["flash_attention"] += 1
                del o
            else:
                o, lse = FA.flash_attention(q, k, v, return_lse=True, **kw)
                do = checks.strided_like(call.tensors[0], torch.randn(
                    q.shape, generator=g, device=dev))
                got = FAB.flash_attention_bwd(q, k, v, o, lse, do, **kw)
                check_close(torch, "flash_attention", o[last],
                            ref.attention_ref(q[last], k[last], v[last],
                                              **kw), tol, rows="last",
                            **shape)
                exp = ref.attention_bwd_ref(*(t[last] for t in (
                    q, k, v, o, lse, do)), **kw)
                gtol = checks.BWD_TOL_BF16 if bf16 else checks.BWD_TOL_F32
                for n, a, e in zip(("dq", "dk", "dv"), got, exp):
                    check_grad(torch, "flash_attention_bwd", a[last], e,
                               gtol, output=n, rows="last", **shape)
                held["flash_attention"] += 1
                held["flash_attention_bwd"] += 1
                del o, lse, do, got, exp
        elif call.name == "attention_cached":
            q, k, v, q_pos, kv_pos = args
            out = CA.attention_cached(q, k, v, q_pos, kv_pos, **kw)
            exp = ref.attention_positions_ref(q, k, v, q_pos, kv_pos, **kw)
            mask = ref.positions_mask(q_pos, kv_pos, **kw)
            sel = mask.any(-1)[:, None, :].expand(out.shape[:3])
            check_close(torch, "attention_cached", out[sel], exp[sel],
                        CACHED_TOL_BF16 if bf16 else ATTN_TOL_F32,
                        keys=int(kv_pos.shape[1]),
                        visible_pairs=int(mask.sum()), **shape)
            if (~sel).any() and float(out[~sel].abs().max()) != 0.0:
                raise AssertionError(f"attention_cached {shape}: rows with "
                                     "no visible key are not 0")
            held["attention_cached"] += 1
            del out, exp, mask, sel
        else:
            fwd, plain, bwd, plain_bwd, names, tol = {
                "wkv6": (WKV.wkv6, ref.wkv6_ref, WKVB.wkv6_bwd,
                         ref.wkv6_bwd_ref, ("dr", "dk", "dv", "dlw", "du",
                                            "dS0"), WKV6_TOL_F32),
                "ssd": (SSD.ssd, ref.ssd_ref, SSDB.ssd_bwd, ref.ssd_bwd_ref,
                        ("dx", "da_log", "dB", "dC", "dS0"), SSD_TOL_F32),
            }[call.name]
            got = fwd(*args, **kw)
            exp = plain(*args, **kw)
            for o, a, e in zip(("out", "state"), got, exp):
                check_close(torch, call.name, a, e,
                            REC_TOL_BF16 if bf16 else tol, output=o, **shape)
            held[call.name] += 1
            del got, exp
            if call.grad:
                dout = checks.strided_like(call.tensors[0], torch.randn(
                    args[0].shape, generator=g, device=dev))
                got = bwd(*args, dout, None)
                # wkv6's u (H, Dh) is shared by the rows
                whole = 4 if call.name == "wkv6" else None
                exp = plain_bwd(*(a if j == whole else a[last]
                                  for j, a in enumerate(args)),
                                dout[last], None)
                gtol = (checks.RECUR_BWD_TOL_BF16 if bf16
                        else checks.RECUR_BWD_TOL_F32)
                for n, a, e in zip(names, got, exp):
                    if n == "du":   # summed over the batch: every row
                        r, k, v = (t.float() for t in args[:3])
                        e = (r * k * (v * dout.float()).sum(-1, True)).sum(
                            (0, 2))
                        check_grad(torch, f"{call.name}_bwd", a, e, gtol,
                                   output=n, rows="all", **shape)
                        continue
                    check_grad(torch, f"{call.name}_bwd", a[last], e, gtol,
                               output=n, rows="last", **shape)
                held[f"{call.name}_bwd"] += 1
                del dout, got, exp
        del args
        torch.cuda.empty_cache()
    emit({"phase": "dryrun_checks", "calls": sum(len(c) for _, c in calls),
          "held": len(seen), "by_kernel": held,
          "s": time.perf_counter() - t0})
    return held


def dryrun_phase(torch, card):
    """``launch.dryrun.run_pair`` for every pair, each arch's weights drawn
    once.  Every row ``ok`` or ``skip`` with its reason; the phase's
    launches reach every attention and recurrence kernel with its
    backward, and no plain version runs on the card.  Then each distinct
    kernel call of the pairs' warm-ups is held against its plain version
    at its own shapes (``dryrun_kernel_checks``)."""
    import gc

    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun as DR
    from repro_torch.models.config import INPUT_SHAPES

    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    # what earlier phases leave on the card (a pair's rows halve when its
    # step does not fit in the rest)
    at_start = {"allocated": torch.cuda.memory_allocated(),
                "reserved": torch.cuda.memory_reserved(),
                "free": torch.cuda.mem_get_info()[0]}
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rows, calls = [], []
    for arch in sorted(ARCHS):
        params = DR.init_weights(arch)
        for shape in INPUT_SHAPES:
            pair_calls = []
            row = DR.run_pair(arch, shape, params=params, card=card,
                              verbose=False, calls=pair_calls)
            emit({"phase": "dryrun", **row})
            rows.append(row)
            calls.append((f"{arch} {shape}", pair_calls))
        del params
        gc.collect()
        torch.cuda.empty_cache()
    counts = ops.launch_counts()
    plain = launch_fields(counts)["plain_on_cuda"]
    status = {s: sum(r["status"] == s for r in rows)
              for s in ("ok", "skip", "fail")}
    emit({"phase": "dryrun_summary", "card": card, **status,
          "s": time.perf_counter() - t0, "memory_at_start": at_start,
          "plain_on_cuda": plain,
          "launches": {k: counts[k] for k in DRYRUN_KERNELS}})
    if (status["fail"] or len(rows) != status["ok"] + status["skip"]
            or plain or not all(counts[k] > 0 for k in DRYRUN_KERNELS)):
        raise AssertionError(f"dryrun: {status}, plain {plain}, "
                             f"{ {k: counts[k] for k in DRYRUN_KERNELS} }")
    held = dryrun_kernel_checks(torch, torch.device("cuda"), calls)
    if not all(held[k] > 0 for k in DRYRUN_KERNELS):
        raise AssertionError(f"dryrun checks: a kernel was not held at a "
                             f"dry-run shape: {held}")
    return {"dryrun": counts}


# training: Adam under the launcher's cosine schedule (peak 3e-4
# over 200 steps, 20 of warmup: its first steps), each model's steps on
# one repeated batch
TRAIN_LR = dict(peak_lr=3e-4, total_steps=200, warmup_steps=20)
# pixtral-12b: 4 layers (≈ 0.29 B parameters a layer beside 1.34 B of
# embeddings and head, 12 bytes a parameter with Adam: ≈ 30 GB), each row
# 1024 stub image patches and 1024 tokens, the loss on the text alone;
# rwkv6-3b at full depth (2.86 B × 12 B ≈ 34 GB with Adam) through the
# wkv6 kernel and its backward, 6 steps: its loss rises at step 3 and
# falls below the first by step 6, through the kernels and through the
# plain version alike (PERF.md §6); zamba2-7b cut to 12 of 81
# layers (two uses of the shared block, ≈ 1.4 B parameters: all 81 need
# ≈ 81 GB with Adam) through ssd and its backward and the flash backward
# at D = 112, causal
TRAIN = {"granite-3-2b": dict(depth=40, batch=8, seq=1024, steps=6),
         "hubert-xlarge": dict(depth=48, batch=4, seq=512, steps=3),
         "granite-moe-3b-a800m": dict(depth=4, batch=8, seq=1024, steps=3),
         "pixtral-12b": dict(depth=4, batch=4, seq=1024, steps=3),
         "rwkv6-3b": dict(depth=32, batch=8, seq=1024, steps=6),
         "zamba2-7b": dict(depth=12, batch=4, seq=1024, steps=3)}
# models whose loss must fall over their steps on the repeated batch (the
# last step's below the first's)
TRAIN_FALLS = ("granite-3-2b", "rwkv6-3b", "zamba2-7b")
# the whole step on the card against the CPU, at full width, f32:
# granite-3-2b on 2 × 256 tokens, hubert-xlarge on 2 × 256 frames (its
# masked loss, bidirectional D = 80), rwkv6-3b on 2 × 256 tokens (wkv6 and
# its backward), zamba2-7b at 6 layers (one use of the shared block) on 2
# × 256, granite-moe-3b-a800m dropless with its aux loss on 2 × 256, and
# pixtral-12b on 1 row of its 1024 stub image patches and 64 tokens (the
# loss on the text alone), each at 2 layers unless said; every gradient
# leaf (and so the sgd update) within TRAIN_TOL_F32 × its max: both sides
# run f32 (no TF32), summing in their own orders through the blocks and
# the output head
TRAIN_CHECK = {"granite-3-2b": dict(depth=2, batch=2, seq=256),
               "hubert-xlarge": dict(depth=2, batch=2, seq=256),
               "rwkv6-3b": dict(depth=2, batch=2, seq=256),
               "zamba2-7b": dict(depth=6, batch=2, seq=256),
               "granite-moe-3b-a800m": dict(depth=2, batch=2, seq=256),
               "pixtral-12b": dict(depth=2, batch=1, seq=64)}
TRAIN_TOL_F32 = 1e-3
# the kernels of a training step: the forward kernel and its backward
TRAIN_KERNELS = (("flash_attention", "flash_attention_bwd"),
                 ("wkv6", "wkv6_bwd"), ("ssd", "ssd_bwd"))
# the profiler's names of each backward's kernels
BWD_KERNEL_NAMES = {"flash_attention_bwd": ("dkdv_", "dq_", "rowdot_"),
                    "wkv6_bwd": ("wkv6_bwd",), "ssd_bwd": ("ssd_bwd",)}


def train_launches(cfg, steps: int) -> dict:
    """The launches that ``steps`` training steps of ``cfg`` must make:
    each attention, wkv6 or ssd layer's forward kernel once a step, and
    again when remat recomputes the block in the backward, and its
    backward kernel once; zamba2's shared block once per ``attn_every``
    Mamba2 layers."""
    uses = {"flash_attention": 0, "wkv6": 0, "ssd": 0}
    if cfg.family == "ssm":
        uses["wkv6"] = cfg.n_layers
    elif cfg.family == "hybrid":
        uses["ssd"] = cfg.n_layers
        uses["flash_attention"] = cfg.n_layers // cfg.attn_every
    else:
        uses["flash_attention"] = cfg.n_layers
    fwd = 2 if cfg.remat else 1
    out = {}
    for f, b in TRAIN_KERNELS:
        out[f] = fwd * uses[f] * steps
        out[b] = uses[f] * steps
    return out


def train_batch(torch, cfg, batch, seq, g):
    """One batch of ``cfg``'s training loss on the card: the launcher's
    token stream (``data.token_lm_batches``) for an LM, after random stub
    image patches for a vlm; random frames with a mask at the config's
    ``mask_prob`` and random targets for the encoder."""
    from repro_torch import data as D
    dev = g.device
    if cfg.family == "encoder":
        mask = torch.rand(batch, seq, generator=g, device=dev) < cfg.mask_prob
        mask[:, 0] = True
        return {"frames": torch.randn(batch, seq, cfg.frame_embed_dim,
                                      generator=g, device=dev),
                "mask": mask,
                "targets": torch.randint(0, cfg.vocab_size, (batch, seq),
                                         generator=g, device=dev)}
    b = D.token_lm_batches(cfg.vocab_size, batch, seq, 1, generator=g,
                           device=dev)[0]
    if cfg.family == "vlm":
        b["img"] = torch.randn(batch, cfg.n_img_tokens, cfg.img_embed_dim,
                               generator=g, device=dev)
    return b


def select_layers(blocks):
    """Each layer's weights by indexing the stacks layer by layer: the
    ``models.model._unstack`` that unbinding replaced, timed beside it."""
    n = next(iter(blocks.values())).shape[0]
    return [{k: v[layer] for k, v in blocks.items()} for layer in range(n)]


def train_model(torch, dev, card, name, depth, batch, seq, steps):
    """``steps`` Adam steps of ``name`` (its first ``depth`` layers, full
    width, bf16, remat on) through ``train.make_train_step`` on one batch,
    counted: flash forward twice a layer and step (the forward, then the
    recompute of the checkpointed block), its backward once, no plain
    version; losses finite.  granite-3-2b's loss must fall over its steps;
    then a step under the profiler, and steps with the stacks indexed
    layer by layer against unbound, in turns.  Returns the launch counts
    of the counted steps."""
    import dataclasses
    import gc
    import statistics

    from repro_torch import optim, train
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as M

    cfg = dataclasses.replace(get_config(name), n_layers=depth)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    t_phase = t0 = time.perf_counter()
    params = M.init_params(cfg, g)
    b = train_batch(torch, cfg, batch, seq, g)
    opt = optim.adam(optim.cosine_schedule(**TRAIN_LR))
    state = opt.init(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    step = train.make_train_step(cfg, opt)
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    rows = []
    for _ in range(steps):
        t0 = time.perf_counter()
        params, state, met = step(params, state, b)
        torch.cuda.synchronize()
        rows.append(dict(s=time.perf_counter() - t0,
                         **{k: float(v) for k, v in met.items()}))
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(r["s"] for r in rows[1:])
    tokens = batch * seq
    plain = sum(v for k, v in counts.items() if k.startswith("plain_on"))
    expect = train_launches(cfg, steps)
    line = {"phase": "train", "model": cfg.name, "family": cfg.family,
            "n_layers": depth, "of_layers": get_config(name).n_layers,
            "n_params": n_params_of(params), "batch": batch, "seq": seq,
            "init_s": init_s, "steps": rows,
            "step_s_median_after_first": med, "tokens_per_s": tokens / med,
            "peak_bytes": peak, **{k: counts[k] for k in expect},
            "expected_launches": expect, "plain_on_cuda": plain,
            "card": card}
    losses = [r["loss"] for r in rows]
    ok = (all(math.isfinite(x) for x in losses)
          and all(counts[k] == n for k, n in expect.items())
          and plain == 0)
    if cfg.n_experts:
        ok = ok and all(r["aux"] > 0 for r in rows)
    if name in TRAIN_FALLS:
        ok = ok and losses[-1] < losses[0]
        bwd = {k: BWD_KERNEL_NAMES[k] for k in BWD_KERNEL_NAMES
               if expect[k]}
        line["profile"] = device_profile(
            torch, lambda: step(params, state, b),
            groups={**bwd, "backward_kernels": sum(bwd.values(), ())})
    if name == "granite-3-2b":
        unstack = M._unstack
        turns = []
        for variant in ("select", "unbind", "select", "unbind"):
            M._unstack = select_layers if variant == "select" else unstack
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            params, state, _ = step(params, state, b)
            torch.cuda.synchronize()
            turns.append({"stacks": variant,
                          "s": time.perf_counter() - t0,
                          "peak_bytes": torch.cuda.max_memory_allocated()})
        M._unstack = unstack
        line["unbind_vs_select"] = turns
    line["s"] = time.perf_counter() - t_phase
    emit(line)
    if not ok:
        raise AssertionError(f"train {name}: losses {losses}, counts "
                             f"{counts}")
    del params, state, b, opt, step
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def check_batch(torch, cfg, batch, seq):
    """A batch of ``cfg``'s loss made on the host with numpy (seed 3), the
    same on the card and on the CPU: tokens and labels for an LM (after
    N(0, 1) stub image patches for a vlm), frames, a mask at
    ``mask_prob`` and targets for the encoder."""
    import numpy as np
    rng = np.random.default_rng(3)
    if cfg.family == "encoder":
        mask = rng.random((batch, seq)) < cfg.mask_prob
        mask[:, 0] = True
        return {"frames": torch.from_numpy(rng.standard_normal(
                    (batch, seq, cfg.frame_embed_dim)).astype(np.float32)),
                "mask": torch.from_numpy(mask),
                "targets": torch.from_numpy(
                    rng.integers(0, cfg.vocab_size, (batch, seq)))}
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, seq + 1)))
    out = {"tokens": ids[:, :-1], "labels": ids[:, 1:]}
    if cfg.family == "vlm":
        out["img"] = torch.from_numpy(rng.standard_normal(
            (batch, cfg.n_img_tokens, cfg.img_embed_dim)).astype(np.float32))
    return out


def train_check(torch, dev, card, name, depth, batch, seq):
    """One sgd step of ``name`` at full width and ``depth`` layers, f32, on
    the card through the kernels against the same step on the CPU through
    the plain versions, same weights and batch (MoE dropless, so that no
    assignment near a capacity boundary can fall on one side alone): the
    loss and each parameter's update within ``TRAIN_TOL_F32`` × its max,
    and the MoE aux loss likewise.  Returns the card step's launch
    counts."""
    import dataclasses

    from repro_torch import optim, train
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as M

    cfg = dropless(dataclasses.replace(get_config(name), n_layers=depth,
                                       dtype="float32"))
    g = torch.Generator()
    g.manual_seed(3)
    on_cpu = M.init_params(cfg, g, device="cpu")
    b = check_batch(torch, cfg, batch, seq)
    t0 = time.perf_counter()
    out = {}
    for where in ("cuda", "cpu"):
        p0 = optim.tree_map(lambda t: t.to(where), on_cpu)
        p1 = optim.tree_map(lambda t: t.clone(), p0)
        opt = optim.sgd(1.0)
        ops.reset_launch_counts()
        _, _, met = train.make_train_step(cfg, opt)(
            p1, opt.init(p1), {k: v.to(where) for k, v in b.items()})
        counts = ops.launch_counts()
        out[where] = (float(met["loss"]), optim.tree_map(
            lambda a, b: (a - b).cpu(), p1, p0), counts, float(met["aux"]))
        del p0, p1
    (loss, upd, counts, aux), (loss_c, upd_c, _, aux_c) = (out["cuda"],
                                                           out["cpu"])
    worst = 0.0
    for a, e in zip(optim.tree_leaves(upd), optim.tree_leaves(upd_c)):
        err, scale = float((a - e).abs().max()), float(e.abs().max())
        worst = max(worst, err / scale if scale else
                    (0.0 if err == 0.0 else math.inf))
    plain = sum(v for k, v in counts.items() if k.startswith("plain_on"))
    expect = train_launches(cfg, 1)
    line = {"phase": "train_check", "model": cfg.name,
            "family": cfg.family, "n_layers": cfg.n_layers,
            "dtype": cfg.dtype, "batch": batch, "seq": seq,
            "loss_card": loss, "loss_cpu": loss_c, "aux_card": aux,
            "aux_cpu": aux_c, "max_rel_update_err": worst,
            "tol": TRAIN_TOL_F32, "s": time.perf_counter() - t0,
            **{k: counts[k] for k in expect}, "plain_on_cuda": plain,
            "card": card}
    emit(line)
    if not (abs(loss - loss_c) <= TRAIN_TOL_F32 * abs(loss_c)
            and abs(aux - aux_c) <= TRAIN_TOL_F32 * abs(aux_c)
            and worst <= TRAIN_TOL_F32 and plain == 0
            and all(counts[k] == n for k, n in expect.items())):
        raise AssertionError(f"train_check: {line}")
    return counts


def train_launcher(torch, card):
    """The reference's launcher at its defaults (granite-3-2b reduced to 4
    layers of d 512, batch 8 × 256) for 20 steps with ``--ckpt``; the
    checkpoint loaded and ``restore_like``'d into the trained parameters'
    structure gives them back bitwise.  Returns the launch counts."""
    import contextlib
    import io

    from repro_torch import checkpoint, optim
    from repro_torch.kernels import ops
    from repro_torch.launch import train as LT

    path = Path(__file__).resolve().parent / "build" / "smoke" / "train.npz"
    ops.reset_launch_counts()
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        loss, params = LT.run(["--steps", "20", "--log-every", "5",
                               "--ckpt", str(path)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    back = checkpoint.restore_like({"params": params, "step": 0},
                                   checkpoint.load(str(path)))
    bitwise = back["step"] == 20 and all(
        a.dtype == b.dtype and torch.equal(a, b)
        for a, b in zip(optim.tree_leaves(back["params"]),
                        optim.tree_leaves(params)))
    plain = sum(v for k, v in counts.items() if k.startswith("plain_on"))
    emit({"phase": "train_launcher", "loss": loss, "s": wall,
          "log": log.getvalue().splitlines(), "ckpt_bytes":
          path.stat().st_size, "restored_bitwise": bitwise,
          "flash_attention": counts["flash_attention"],
          "flash_attention_bwd": counts["flash_attention_bwd"],
          "plain_on_cuda": plain, "card": card})
    path.unlink()
    if not (bitwise and math.isfinite(loss) and plain == 0
            and counts["flash_attention_bwd"] == 4 * 20):
        raise AssertionError(f"train_launcher: loss {loss}, bitwise "
                             f"{bitwise}, counts {counts}")
    return counts


def train_phase(torch, dev, card):
    """Training through the forward kernels and their hand-written
    backwards (flash, wkv6, ssd): ``TRAIN``'s models, the whole-step
    checks and the launcher.  Returns each run's launch counts."""
    counts = {}
    for name, spec in TRAIN.items():
        counts[f"train {name}"] = train_model(torch, dev, card, name, **spec)
    for name, spec in TRAIN_CHECK.items():
        counts[f"train_check {name}"] = train_check(torch, dev, card, name,
                                                    **spec)
    counts["train_launcher"] = train_launcher(torch, card)
    return counts


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    try:
        from repro_torch import resolve_device
        from repro_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = resolve_device("cuda")
    card = card_line()
    emit({"gpu": card, "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})

    t0 = time.perf_counter()
    reports = _build.build(_build.SOURCES)
    emit({"phase": "build", "s": time.perf_counter() - t0,
          "ptxas": {s: _build.ptxas_summary(r)
                    for s, r in reports.items()}})

    kres = kernel_phase(torch, dev, card)
    counts = {}
    for name in PATHS:
        keep = {} if name == "hubert-xlarge" else None
        counts[name] = main_path(torch, dev, card, name, keep, counts)
        if keep is not None:
            counts.update(slice_paths(torch, dev, card, keep))
            counts.update(slice6_paths(torch, dev, card, keep))
            counts.update(mesh_phase(torch, dev, card, keep))
            counts.update(analysis_phase(torch, dev, card, keep))
            keep.clear()
    counts.update(serving_paths(torch, dev, card))
    for name, spec in WIDE.items():
        counts.update(wide_phase(torch, dev, card, name, **spec))
    counts.update(train_phase(torch, dev, card))
    counts.update(dryrun_phase(torch, card))

    sources = {"estep_fused": ("src/repro_torch/kernels/csrc/gmm_estep.cu",
                               "src/repro/kernels/gmm_estep.py:177"),
               "estep": ("src/repro_torch/kernels/csrc/gmm_estep.cu",
                         "src/repro/kernels/gmm_estep.py:171"),
               "flash_attention": (
                   "src/repro_torch/kernels/csrc/flash_attention.cu",
                   "src/repro/kernels/flash_attention.py:127"),
               "wkv6": ("src/repro_torch/kernels/csrc/wkv6.cu",
                        "src/repro/kernels/wkv6.py:96"),
               "ssd": ("src/repro_torch/kernels/csrc/ssd.cu",
                       "src/repro/kernels/ssd.py:91"),
               # no TPU kernel: the reference's XLA _sdpa_chunked
               "attention_cached": (
                   "src/repro_torch/kernels/csrc/attention_cached.cu",
                   None),
               # no TPU kernel: XLA's autodiff of _sdpa_chunked
               "flash_attention_bwd": (
                   "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                   None),
               # no TPU kernel: XLA's autodiff of wkv6_chunked, ssd_chunked
               "wkv6_bwd": ("src/repro_torch/kernels/csrc/wkv6_bwd.cu",
                            None),
               "ssd_bwd": ("src/repro_torch/kernels/csrc/ssd_bwd.cu", None),
               # no TPU kernel: XLA fuses the reference's rms_norm
               "rms_norm": ("src/repro_torch/kernels/csrc/rms_norm.cu",
                            None)}
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "device_ms")
    kernels = []
    for name, (src, rep) in sources.items():
        by_path = {p: c[name] for p, c in counts.items() if c.get(name)}
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": rep, "launches": sum(by_path.values()),
                 "launches_by_path": by_path,
                 **{k: kres[name][k] for k in keys}}
        if name == "attention_cached":
            entry["by_shape"] = [
                {kk: r[kk] for kk in ("case", "shape", "window", *keys,
                                      "library_device_ms", "graph_ms",
                                      "library_graph_ms")}
                for r in kres[name]["by_shape"]]
        if name in ("wkv6_bwd", "ssd_bwd"):
            entry.update({kk: kres[name][kk] for kk in (
                "case", "shape", "graph_ms")})
        if name == "rms_norm":
            entry["by_shape"] = [
                {kk: r[kk] for kk in ("case", "shape", "gated", *keys,
                                      "graph_ms")}
                for r in kres[name]["by_shape"]]
        if name == "flash_attention_bwd":
            entry.update({kk: kres[name][kk] for kk in (
                "shape", "graph_ms", "library_device_ms")})
            entry["by_shape"] = [
                {kk: r[kk] for kk in ("case", "shape", "causal", *keys,
                                      "library_device_ms", "graph_ms")}
                for r in kres[name]["by_shape"]]
        if name == "flash_attention":   # zamba2-7b's D = 112, FLASH_CASES
            entry["by_shape"] = [
                {"case": k, "shape": kres[k]["shape"],
                 "causal": kres[k]["causal"],
                 **{kk: kres[k][kk] for kk in (*keys, "library_device_ms",
                                               "graph_ms",
                                               "library_graph_ms")}}
                for k in kres if k.startswith("flash_attention")
                and k != "flash_attention_bwd"]
        kernels.append(entry)
    emit({"card": card, "kernels": kernels,
          "smoke_s": time.perf_counter() - t_start})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
