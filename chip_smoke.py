#!/usr/bin/env python3
"""Drive the PyTorch port's FedPFT main path once on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each one against its plain PyTorch version on the card and times
both, then runs the paper's Algorithm 1 through the port's entry points
at the full width of hubert-xlarge (48 layers, d_model 1280, random
weights from a seed): foundation features → per-client class-wise diag
GMMs by batched EM → bf16 wire → the server's fused head → accuracy
against the centralized oracle.  Launch counters show that the main path
ran through every kernel and never through a plain version.

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
N_TIMED = 25


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn) -> float:
    """Median over N_TIMED launches, each between two CUDA events."""
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


def device_profile(torch, fn) -> dict:
    """Wall time of one call of ``fn`` under torch.profiler, the device
    time of the kernels it ran (top 8 by name) and the device's idle
    share.  The profiler's own cost inflates the wall time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = {}
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            ms = float(getattr(e, "self_device_time_total", 0.0)) / 1e3
            if ms > 0:
                kernels[e.key[:90]] = kernels.get(e.key[:90], 0.0) + ms
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_ms,
            "device_busy_ms": busy if kernels else None,
            "idle_share": 1.0 - busy / wall_ms if kernels else None,
            "top_kernels_ms": top}


def check_close(torch, name, got, exp, tol, **shape) -> float:
    """max |got − exp|; raises unless |got − exp| ≤ tol + tol·|exp|."""
    torch.cuda.synchronize()
    got, exp = got.float(), exp.float()
    err = (got - exp).abs()
    bad = int((err > tol + tol * exp.abs()).sum())
    finite = bool(torch.isfinite(got).all())
    max_err = float(err.max())
    emit({"phase": "kernel_check", "kernel": name, **shape,
          "max_abs_err": max_err, "tol": tol, "mismatches": bad,
          "finite": finite})
    if bad or not finite:
        raise AssertionError(f"{name} {shape}: {bad} elements outside "
                             f"tol {tol} (max abs err {max_err})")
    return max_err


def estep_inputs(torch, g, dev, Bx, B, N, K, d, spher=False):
    x = torch.randn(Bx, N, d, generator=g, device=dev)
    mu = torch.randn(B, K, d, generator=g, device=dev)
    var = torch.nn.functional.softplus(
        torch.randn((B, K) if spher else (B, K, d), generator=g,
                    device=dev)) + 0.1
    pi = torch.softmax(torch.randn(B, K, generator=g, device=dev), -1)
    return x, mu, var, pi


def kernel_phase(torch, dev, card):
    """Every kernel against its plain version at the main path's and the
    edge shapes; times at the main path's shapes."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import gmm_estep as GE
    from repro_torch.kernels import ref

    g = torch.Generator(device=dev)
    g.manual_seed(1)
    res = {}

    # --- E-step: per-client (B = C = 10), cohort (Bx = 4), ragged spher
    for tag, (Bx, B, N, K, d, spher) in {
            "main": (1, 10, 1000, 10, 1280, False),
            "cohort": (4, 40, 1000, 10, 1280, False),
            "ragged_spher": (1, 3, 1001, 7, 1280, True)}.items():
        args = estep_inputs(torch, g, dev, Bx, B, N, K, d, spher)
        lp, lse = GE.estep_fused(*args)
        elp, else_ = ref.estep_fused_ref(*args)
        shape = dict(case=tag, Bx=Bx, B=B, N=N, K=K, d=d, spher=spher)
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
                plain_ms=time_ms(torch, lambda: ref.estep_fused_ref(
                    x, mu, var, pi)),
                library_ms=None, flops=flops, bytes=nbytes,
                peak=F32_FLOPS)

    x, mu, var, pi = (a[0] for a in estep_inputs(torch, g, dev, 1, 1, 1000,
                                                 10, 1280))
    err = check_close(torch, "estep", GE.estep(x, mu, var, pi),
                      ref.estep_ref(x, mu, var, pi), ESTEP_TOL, N=1000, K=10,
                      d=1280)
    res["estep"] = dict(
        max_abs_err=err,
        ms=time_ms(torch, lambda: GE.estep(x, mu, var, pi)),
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
        if "flash_attention" not in res:        # the encoder's shape
            sdpa = torch.nn.functional.scaled_dot_product_attention
            res["flash_attention"] = dict(
                max_abs_err=err,
                ms=time_ms(torch, lambda: FA.flash_attention(q, k, v, **kw)),
                plain_ms=time_ms(torch, lambda: ref.attention_ref(q, k, v,
                                                                  **kw)),
                library_ms=time_ms(torch, lambda: sdpa(q, k, v)),
                flops=4.0 * B * H * Sq * Sk * D,
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

    for name, r in res.items():
        r["bound_ms"] = 1e3 * max(r["flops"] / r["peak"],
                                  r["bytes"] / HBM_BYTES_S)
        r["bound_by"] = ("operations" if r["flops"] / r["peak"]
                         >= r["bytes"] / HBM_BYTES_S else "bytes")
        emit({"phase": "kernel_time", "kernel": name, "card": card,
              **{k: r[k] for k in ("ms", "plain_ms", "library_ms",
                                   "bound_ms", "bound_by")}})
    return res


def frames_of(np, x, n_frames, frame_dim):
    """Each input vector cut into n_frames frames, zero-padded to the
    encoder's frame_embed_dim (benchmarks/common.py's framing)."""
    n, d_in = x.shape
    per = d_in // n_frames
    fr = x[:, :per * n_frames].reshape(n, n_frames, per)
    return np.pad(fr, ((0, 0), (0, 0), (0, frame_dim - per)))


def main_path(torch, dev, card):
    import dataclasses

    import numpy as np

    from repro_torch import data as D
    from repro_torch.configs import get_config
    from repro_torch.core import fedpft as FP
    from repro_torch.core import gmm as G
    from repro_torch.core import head as H
    from repro_torch.fl import api as A
    from repro_torch.kernels import ops
    from repro_torch.models import model as M

    cfg = get_config("hubert-xlarge")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    t0 = time.perf_counter()
    params = M.init_params(cfg, g)
    torch.cuda.synchronize()
    n_params = sum(v.numel() for v in params["blocks"].values()) \
        + sum(params[k].numel() for k in ("frame_proj", "mask_emb",
                                          "final_norm", "lm_head"))
    emit({"phase": "init", "model": cfg.name, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "n_params": n_params,
          "s": time.perf_counter() - t0, "card": card})

    dcfg = D.DatasetConfig(n_classes=10, n_per_class=400, input_dim=512,
                           class_sep=3.0)
    x, y = D.make_dataset(dcfg)
    xt, yt = D.make_dataset(dataclasses.replace(dcfg, n_per_class=100),
                            split=1)
    fr = frames_of(np, x, 64, cfg.frame_embed_dim)
    frt = frames_of(np, xt, 64, cfg.frame_embed_dim)

    ops.reset_launch_counts()
    # ---- the counted run: features → clients → wire → head → accuracy
    t0 = time.perf_counter()
    feats = torch.cat([M.features(cfg, params, {"frames": fr[i:i + 256]})
                       for i in range(0, len(fr), 256)])
    feats_t = torch.cat([M.features(cfg, params, {"frames": frt[i:i + 256]})
                         for i in range(0, len(frt), 256)])
    torch.cuda.synchronize()
    t_feat = time.perf_counter() - t0
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

    comm = res.info["comm_bytes"]
    payload = sum(len(m.payload) for m in res.messages)
    emit({"phase": "main_path", "card": card, "features_s": t_feat,
          **res.info["phase_s"], "centralized_s": t_central,
          "n_train": int(feats.shape[0]), "n_test": int(feats_t.shape[0]),
          "n_clients": len(clients), "comm_bytes": comm,
          "payload_bytes": payload, "acc": acc, "acc_centralized": acc_c,
          "heldout_loglik_mean": sum(heldout) / len(heldout),
          "launches": counts})
    if not (torch.isfinite(feats).all() and torch.isfinite(feats_t).all()
            and feats.shape == (len(y), cfg.d_model)):
        raise AssertionError(f"features are not finite ({len(y)}, "
                             f"{cfg.d_model})")
    if comm != payload:
        raise AssertionError(f"comm_bytes {comm} != Σ len(payload) "
                             f"{payload}")
    if not acc > acc_c - 0.08:                 # tests/test_system.py:70
        raise AssertionError(f"FedPFT acc {acc} not > centralized "
                             f"{acc_c} − 0.08")
    if not all(math.isfinite(v) for v in heldout):
        raise AssertionError("non-finite held-out log-likelihood")
    for name in ("estep_fused", "estep", "flash_attention"):
        if counts[name] < 1:
            raise AssertionError(f"the main path never launched {name}")
    plain = {k: v for k, v in counts.items() if k.startswith("plain_on")}
    if any(plain.values()):
        raise AssertionError(f"plain versions ran on CUDA tensors: {plain}")

    # where the time goes: one features batch, one client, the server
    g2 = torch.Generator(device=dev)
    g2.manual_seed(1)
    f0, y0 = clients[0]
    for name, fn in (
            ("features_batch_256", lambda: M.features(
                cfg, params, {"frames": fr[:256]})),
            ("client_fit_and_encode", lambda: sess.encode(
                *sess.client_summary(f0, y0, 0, generator=g2, device=dev))),
            ("server_head", lambda: sess.server_aggregate(
                res.messages, generator=g2, device=dev))):
        emit({"phase": "profile", "part": name, "card": card,
              **device_profile(torch, fn)})

    # the card's features against the plain CPU path on a small input:
    # the same weights cut to two layers, two samples
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    p2 = {k: v for k, v in params.items() if k != "blocks"}
    p2["blocks"] = {k: v[:2] for k, v in params["blocks"].items()}
    p2_cpu = {k: v.cpu() for k, v in p2.items() if k != "blocks"}
    p2_cpu["blocks"] = {k: v.cpu() for k, v in p2["blocks"].items()}
    small = {"frames": frt[:2]}
    on_card = M.features(cfg2, p2, small)
    on_cpu = M.features(cfg2, p2_cpu, small, device="cpu")
    check_close(torch, "features (2 layers, card vs CPU plain path)",
                on_card.cpu(), on_cpu, ATTN_TOL_BF16, n=2)
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
    dev = resolve_device("cuda")
    card = card_line()
    emit({"gpu": card, "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})

    t0 = time.perf_counter()
    reports = _build.build(["gmm_estep.cu", "flash_attention.cu"])
    emit({"phase": "build", "s": time.perf_counter() - t0,
          "ptxas": {s: [ln.strip() for ln in r.splitlines()
                        if "registers" in ln or "spill" in ln]
                    for s, r in reports.items()}})

    kres = kernel_phase(torch, dev, card)
    counts = main_path(torch, dev, card)

    sources = {"estep_fused": ("src/repro_torch/kernels/csrc/gmm_estep.cu",
                               "src/repro/kernels/gmm_estep.py:177"),
               "estep": ("src/repro_torch/kernels/csrc/gmm_estep.cu",
                         "src/repro/kernels/gmm_estep.py:171"),
               "flash_attention": (
                   "src/repro_torch/kernels/csrc/flash_attention.cu",
                   "src/repro/kernels/flash_attention.py:127")}
    emit({"card": card, "kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[name], "max_abs_err": kres[name]["max_abs_err"],
         "ms": kres[name]["ms"], "plain_ms": kres[name]["plain_ms"],
         "bound_ms": kres[name]["bound_ms"],
         "bound_by": kres[name]["bound_by"],
         "library_ms": kres[name]["library_ms"]}
        for name, (src, rep) in sources.items()]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
