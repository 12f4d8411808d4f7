"""Time versions of the bf16 kernels side by side on one card, in turns.

    python3 src/repro_torch/kernels/compare.py --tree NAME=DIR [--tree ...]
        [--flash NAME=BASE:FILE.cu[:ABLATION] ...]
        [--ablate NAME=BASE:ABLATION[:ABLATION] ...] [--rounds 2]
        [--only flash,ssd,wkv6,estep,cached,bwd,wkv6_bwd,ssd_bwd,rms_norm]
        [--out build/compare.jsonl]
    python3 src/repro_torch/kernels/compare.py --sweep-estep
        [--out build/estep_plans.jsonl]
    python3 src/repro_torch/kernels/compare.py --sweep-cached
        [--out build/cached_splits.jsonl]

A ``--tree`` is a checkout of the repository: ``.`` for the working tree,
or a commit unpacked into a git-ignored directory, as in
``git archive <commit> | tar -x -C build/exp/<name>``.  A ``--flash``
version is the tree named BASE with its ``csrc/flash_attention.cu``
replaced by FILE (copied to ``build/exp/cmp-<NAME>``; ``kernels/variants/``
holds the measured alternatives), optionally cut by an ABLATION.  An
``--ablate`` version is the tree BASE with ABLATIONS applied to its
sources: each times one part of a kernel alone or leaves one part out
(``ABLATIONS`` below: flash's copies or products alone; ``wkv6`` or the
E-step without one part).  Ablated versions give wrong outputs by design;
their errors are reported, not checked.  Each round runs
every version in turn, then again in the reverse order (A B … B A), each
in a child process that imports that version's ``repro_torch``, builds
its kernels into the version's own ``build/kernels/``, holds flash at the
encoder's and zamba2-7b's shapes and at ``checks.FLASH_CASES`` (the wide
heads, MQA; a case whose head dim the version's flash source does not
instantiate, as D = 160 and 192 in ``kernels/variants/``, is reported as
``skipped``), ``ssd`` at the zamba2-7b path's shape,
``wkv6`` at the rwkv6-3b path's shape, the two E-steps and
``attention_cached`` at the serving paths' shapes
(``checks.CACHED_CASES``) against their plain versions, and times each
kernel (and SDPA beside flash and ``attention_cached``) two ways:

- ``single_ms``: the median over 25 calls of an event pair around one
  call, the card idle between calls; this counts the host's work to
  launch the call (the wrapper's checks and its ``ctypes`` call) as well.
- ``device_ms``: 25 calls back to back between two events, the median of
  three such runs, per call: the card's time, the host's launch work
  overlapped with it.
- ``graph_ms`` (``attention_cached`` and its SDPA, flash's backward): one
  call captured in a CUDA graph and replayed, the card's time with no host
  work.  (SDPA's backward is autograd of a forward made on the default
  stream, which a capture on a side stream refuses.)

``--only`` builds and times the named groups alone (``flash``, ``ssd``,
``wkv6``, ``estep``: both E-steps, ``cached``, ``bwd``: flash's backward
at the training shapes ``BWD_TIMED``, each that the tree's
``checks.BWD_CASES`` and head dims hold, with SDPA's backward beside it;
``wkv6_bwd``, ``ssd_bwd``: the recurrences' backward at rwkv6-3b's and
zamba2-7b's training shapes, ``checks.RECUR_BWD_CASES``, with each
kernel's time per call from ``torch.profiler``, ``phases_ms``;
``rms_norm``: the one-pass norm at the benchmark's rows,
``checks.RMS_NORM_TIMED``); a tree from before ``attention_cached``, a
backward or the norm needs ``--only`` without its group.  Prints
one JSON object per version and round, then a summary; writes both to
``--out``.
``--sweep-estep`` times every launch plan of the E-step kernel at the main
path's shapes (one CUDA graph replayed: the card's time alone) and says
where the wrapper's pick ranks; ``--sweep-cached`` does the same for every
key split of ``attention_cached`` at its check shapes.  ``chip_smoke.py``
takes its timers from here.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import Tuple

N_TIMED = 25
# name: B, H, S, D, causal (the encoder's and zamba2-7b's shared block)
FLASH = {"flash_attention": (256, 16, 64, 80, False),
         "flash_attention_d112": (64, 32, 512, 112, True)}
SSD_MAIN = (64, 112, 512, 64, 64)       # Bt, H, T, N, P; the model's chunk
SSD_CHUNK = 256
WKV6_MAIN = (64, 40, 512, 64)           # B, H, T, Dh; the model's chunk
WKV6_CHUNK = 64
# flash's backward: the training shapes of kernels.checks.BWD_CASES timed
# (granite-3-2b, hubert-xlarge, pixtral-12b, nemotron-4-340b's heads,
# zamba2-7b's shared block)
BWD_TIMED = ("granite_train", "hubert_train", "pixtral_train",
             "nemotron_train", "zamba2_train")


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


# --only: each group's source and the kernels it times
GROUPS = {"flash": "flash_attention.cu", "ssd": "ssd.cu", "wkv6": "wkv6.cu",
          "estep": "gmm_estep.cu", "cached": "attention_cached.cu",
          "bwd": "flash_attention_bwd.cu", "wkv6_bwd": "wkv6_bwd.cu",
          "ssd_bwd": "ssd_bwd.cu", "rms_norm": "rms_norm.cu"}


def head_dims(text: str) -> set:
    """The head dims a flash source instantiates: the ``case D: return
    launch<D>`` lines of its switch over D (any other D returns
    ``cudaErrorInvalidValue``)."""
    return {int(d) for d in re.findall(r"case (\d+): return launch<\1>",
                                       text)}


def flash_group_cases(text: str, flash_cases) -> Tuple[dict, set]:
    """The ``flash`` group's cases for a version whose flash source is
    ``text``: (name → (B, H, Hkv, Sq, Sk, D, causal), in the order they
    run: the encoder's and zamba2-7b's shapes, then ``flash_cases``, the
    version's ``checks.FLASH_CASES``), and the names whose D the source
    does not instantiate, which the group skips."""
    cases = {n: (B, H, H, S, S, D, causal)
             for n, (B, H, S, D, causal) in FLASH.items()}
    cases.update({f"flash_attention/{tag}": tuple(c)
                  for tag, c in flash_cases.items()})
    dims = head_dims(text)
    return cases, {n for n, c in cases.items() if c[5] not in dims}


def _shown(path: Path) -> str:
    """``path`` relative to this repository when it lies inside it."""
    root = Path(__file__).resolve().parents[3]
    try:
        return str(path.resolve().relative_to(root))
    except ValueError:
        return str(path)


# the recurrences' backward: each group's training shape in
# checks.RECUR_BWD_CASES
RECUR_BWD_TIMED = {"wkv6_bwd": "rwkv6_train", "ssd_bwd": "zamba2_train"}


def child(label: str, only: str = "") -> dict:
    """One version: build, check and time its kernels on the card (the
    groups named in ``only``, comma-separated, or all)."""
    import torch
    from repro_torch.kernels import _build, checks, ref
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import gmm_estep as GE
    from repro_torch.kernels import ssd as SSD
    from repro_torch.kernels import wkv6 as WKV

    groups = only.split(",") if only else list(GROUPS)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    reports = _build.build([GROUPS[grp] for grp in groups])
    # an older tree's builder has no summary: its raw lines
    summary = getattr(_build, "ptxas_summary", lambda rep: [
        ln.strip() for ln in rep.splitlines()
        if "registers" in ln or "spill" in ln])
    res = {"version": label, "tree": str(Path(_build.CSRC).parents[3]),
           "build_s": time.perf_counter() - t0,
           "ptxas": {src: summary(rep) for src, rep in reports.items()}}
    # each group draws its inputs from its own seed, whatever runs before
    g = torch.Generator(device=dev)
    if "flash" in groups:
        g.manual_seed(0)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        source = Path(_build.CSRC) / GROUPS["flash"]
        cases, skipped = flash_group_cases(
            source.read_text(), getattr(checks, "FLASH_CASES", {}))
        for name, (B, H, Hkv, Sq, Sk, D, causal) in cases.items():
            # a skipped case's inputs are drawn too: every version gets
            # the same inputs for each case
            q = torch.randn(B, H, Sq, D, generator=g, device=dev).to(
                torch.bfloat16)
            k, v = (torch.randn(B, Hkv, Sk, D, generator=g, device=dev)
                    .to(torch.bfloat16) for _ in range(2))
            if name in skipped:
                res[name] = {"skipped": f"D not in {_shown(source)}"}
                continue
            kx, vx = (t.repeat_interleave(H // Hkv, dim=1) for t in (k, v))
            got = FA.flash_attention(q, k, v, causal=causal)
            exp = ref.attention_ref(q, k, v, causal=causal)
            res[name] = {
                "max_abs_err": float((got.float() - exp.float()).abs().max()),
                **_times(torch, lambda: FA.flash_attention(q, k, v,
                                                           causal=causal)),
                "library": _times(torch, lambda: sdpa(q, kx, vx,
                                                      is_causal=causal))}
            del q, k, v, kx, vx, got, exp
    for grp, fn, plain, inputs, shape, chunk in (
            ("ssd", SSD.ssd, ref.ssd_ref, checks.ssd_inputs, SSD_MAIN,
             SSD_CHUNK),
            ("wkv6", WKV.wkv6, ref.wkv6_ref, checks.wkv6_inputs, WKV6_MAIN,
             WKV6_CHUNK)):
        if grp not in groups:
            continue
        # each case's inputs from seed 0: the same in every version
        g.manual_seed(0)  # lint: disable=KEY-REUSE
        args = inputs(g, dev, *shape, torch.bfloat16, 0.0, model_like=True)
        got = fn(*args, chunk=chunk)
        exp = plain(*args, chunk=chunk)
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(got, exp))
        res[grp] = {"max_abs_err": err,
                    **_times(torch, lambda: fn(*args, chunk=chunk))}
        del args, got, exp
    if "estep" in groups:
        # each case's inputs from seed 0: the same in every version
        g.manual_seed(0)  # lint: disable=KEY-REUSE
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
            .abs().max()), **_times(torch, lambda: GE.estep(
                x0, mu0, var0, pi0))}
    if "cached" in groups:
        from repro_torch.kernels import attention_cached as CA
        # each case's inputs from seed 0: the same in every version
        g.manual_seed(0)  # lint: disable=KEY-REUSE
        # the floor of graph_ms: one replay of a graph of one tiny kernel
        tiny = torch.zeros(1, device=dev)
        res["graph_floor_ms"] = graph_ms(torch, tiny.zero_)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        for tag, case in checks.CACHED_CASES.items():
            B, H, Hkv, Sq, Sk, D, window, kind = case
            q, k, v, qp, kp = checks.cached_inputs(g, dev, *case,
                                                   dtype=torch.bfloat16)
            mask = ref.positions_mask(qp, kp, window=window)
            sel = mask.any(-1)[:, None, :].expand(q.shape[:3])
            got = CA.attention_cached(q, k, v, qp, kp, window=window)
            exp = ref.attention_positions_ref(q, k, v, qp, kp, window=window)
            kx, vx = (t.repeat_interleave(H // Hkv, dim=1) for t in (k, v))

            def call():
                return CA.attention_cached(q, k, v, qp, kp, window=window)

            def lib():
                return sdpa(q, kx, vx, attn_mask=mask[:, None])
            res[f"attention_cached/{tag}"] = {
                "max_abs_err": float((got.float() - exp.float())[sel].abs()
                                     .max()),
                **_times(torch, call), "graph_ms": graph_ms(torch, call),
                "library": {**_times(torch, lib),
                            "graph_ms": graph_ms(torch, lib)}}
    if "bwd" in groups:
        # flash attention's backward on the forward's o and lse, beside
        # SDPA's backward (K and V repeated over the group); older trees
        # have no backward, or fewer head dims
        from repro_torch.kernels import flash_attention_bwd as FAB
        sdpa = torch.nn.functional.scaled_dot_product_attention
        for tag in BWD_TIMED:
            case = checks.BWD_CASES.get(tag)
            if case is None or case[5] not in FAB.HEAD_DIMS:
                continue
            # each case's inputs from seed 0: the same in every version
            g.manual_seed(0)  # lint: disable=KEY-REUSE
            B, H, Hkv, Sq, Sk, D, causal, _, _ = case
            q, k, v, do = checks.bwd_inputs(g, dev, B, H, Hkv, Sq, Sk, D,
                                            torch.bfloat16)
            o, lse = FA.flash_attention(q, k, v, causal=causal,
                                        return_lse=True)
            G = H // Hkv
            qs, ks, vs = (t.detach().requires_grad_() for t in (
                q, k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)))
            out = sdpa(qs, ks, vs, is_causal=causal)

            def call():
                return FAB.flash_attention_bwd(q, k, v, o, lse, do,
                                               causal=causal)

            def lib():
                return torch.autograd.grad(out, (qs, ks, vs), do,
                                           retain_graph=True)
            exp = ref.attention_bwd_ref(q, k, v, o, lse, do, causal=causal)
            res[f"flash_attention_bwd/{tag}"] = {
                "max_abs_err": max(float((a.float() - e.float()).abs().max())
                                   for a, e in zip(call(), exp)),
                **_times(torch, call), "graph_ms": graph_ms(torch, call),
                "library": _times(torch, lib)}
            del q, k, v, do, o, lse, qs, ks, vs, out, exp
    for grp, tag in RECUR_BWD_TIMED.items():
        if grp not in groups:
            continue
        from repro_torch.kernels import ssd_bwd, wkv6_bwd
        fn, plain = ((wkv6_bwd.wkv6_bwd, ref.wkv6_bwd_ref) if grp == "wkv6_bwd"
                     else (ssd_bwd.ssd_bwd, ref.ssd_bwd_ref))
        kernel, dims, _, scale, fill = checks.RECUR_BWD_CASES[tag]
        # each case's inputs from seed 0: the same in every version
        g.manual_seed(0)  # lint: disable=KEY-REUSE
        args, dout, dS = checks.recur_bwd_inputs(g, dev, kernel, dims,
                                                 torch.bfloat16, scale, fill)

        def call():
            return fn(*args, dout, dS)
        res[f"{grp}/{tag}"] = {
            "max_rel_err": max(
                float((a.float() - e.float()).abs().max())
                / float(e.float().abs().max())
                for a, e in zip(call(), plain(*args, dout, dS))),
            **_times(torch, call), "graph_ms": graph_ms(torch, call),
            "phases_ms": kernel_ms(torch, call)}
        del args, dout, dS
    if "rms_norm" in groups:
        from repro_torch.kernels import rms_norm as RMS
        # the benchmark's rows, drawn in turn from one stream of their own:
        # the same in every version
        gn = torch.Generator(device=dev)
        gn.manual_seed(5)
        for tag in checks.RMS_NORM_TIMED:
            rows, d, dt, gated = checks.RMS_NORM_CASES[tag]
            x, gamma, z = checks.rms_norm_inputs(gn, dev, rows, d, dt, gated)

            def norm():
                return RMS.rms_norm(x, gamma, z=z)
            res[f"rms_norm/{tag}"] = {
                "max_abs_err": float((norm().float() - ref.rms_norm_ref(
                    x, gamma, z=z).float()).abs().max()),
                **_times(torch, norm), "graph_ms": graph_ms(torch, norm)}
            del x, gamma, z
    return res


# text edits that time one part of a kernel alone (their outputs are wrong
# by design), or a variant of it: name: (the csrc source edited, [(line,
# replacement), ...])
ABLATIONS = {
    # flash's key-tile loop (and the variants that share it): the copies
    # and barriers alone, or the products and softmax on stale tiles
    "copies_only": ("flash_attention.cu", [
        ("    if (!(tile < w_pre || (tile >= w_lo && tile < w_hi)))"
         " continue;\n", "    continue;\n")]),
    "products_only": ("flash_attention.cu", [
        ("if (idx + 1 < n_vis) issue(idx + 1, (idx + 1) % NST);",
         "if (idx == 0 && n_vis > 1) issue(1, 1);")]),
    # bf16 wkv6 without one part of a chunk: the exact diagonal quadrants
    # and the bonus, A over the earlier s-tiles, r_dec S, the next chunk's
    # copies
    "wkv6_no_exact": ("wkv6.cu", [
        ("    if (lane < 28) {\n", "    if (lane < 0) {\n"),
        ("    if (lane < 16) {\n", "    if (lane < 0) {\n")]),
    "wkv6_no_kt": ("wkv6.cu", [("      if (J >= warp) break;\n",
                                "      if (J >= 0) break;\n")]),
    "wkv6_no_rdec_s": ("wkv6.cu", [
        ("    for (int ks = 0; ks < 4; ++ks) {\n"
         "      uint32_t sh[DP / 16][4]",
         "    for (int ks = 0; ks < 0; ++ks) {\n"
         "      uint32_t sh[DP / 16][4]")]),
    "wkv6_no_copies": ("wkv6.cu", [("    if (c + 1 < nc) load(c + 1);\n",
                                    "    if (c + 1 < 1) load(c + 1);\n")]),
    # the bf16 wkv6 backward's outputs phase without one part: the exact
    # 8 x 8 diagonal quadrants (of dr, dk and A, the bonus; or of A and
    # the bonus alone), or the products over the step tiles before and
    # after a warp's rows
    "wkv6_bwd_no_exact": ("wkv6_bwd.cu", [
        ("      for (int i = 2; i < 8; ++i) {\n",
         "      for (int i = 2; i < 2; ++i) {\n"),
        ("    if (lane < 28) {\n", "    if (lane < 0) {\n"),
        ("    if (lane < 16) {\n", "    if (lane < 0) {\n")]),
    "wkv6_bwd_no_exact_a": ("wkv6_bwd.cu", [
        ("    if (lane < 28) {\n", "    if (lane < 0) {\n"),
        ("    if (lane < 16) {\n", "    if (lane < 0) {\n")]),
    "wkv6_bwd_no_off": ("wkv6_bwd.cu", [
        ("    if (warp < 3) {\n      uint32_t kt",
         "    if (warp < 0) {\n      uint32_t kt"),
        ("    if (warp > 0) {\n", "    if (warp > 3) {\n"),
        ("    if (warp < 3) {\n      zero(acc);",
         "    if (warp < 0) {\n      zero(acc);")]),
    # the bf16 ssd backward's outputs phase held to 168 registers, three
    # blocks an SM
    "ssd_bwd_grads_3_blocks": ("ssd_bwd.cu", [
        ("__launch_bounds__(NTH, 2)\nssd_bwd_chunk_grads",
         "__launch_bounds__(NTH, 3)\nssd_bwd_chunk_grads")]),
    # the bf16 flash backward's dK/dV warps taking 16 queries at a time at
    # every head dim, or 64 up to D = 64; right outputs
    "bwd_q_step_16": ("flash_attention_bwd.cu", [
        ("return D <= 64 ? 16 : D <= 128 ? 32 : 16;", "return 16;")]),
    "bwd_q_step_64": ("flash_attention_bwd.cu", [
        ("return D <= 64 ? 16 :", "return D <= 64 ? 64 :")]),
    # the E-step kernel without the copies past the first chunks, or
    # without its sums
    "estep_no_copies": ("gmm_estep.cu", [
        ("      if (ch + NST - 1 < nch) load(ch + NST - 1);\n", "")]),
    "estep_no_sums": ("gmm_estep.cu", [
        ("      for (int kk = 0; kk < KT; ++kk) {\n        const float4 iv",
         "      for (int kk = 0; kk < KT * (ch < 0); ++kk) {\n"
         "        const float4 iv")]),
}


def ablate(text: str, source: str, cut: str) -> str:
    """``text`` of ``source`` with ablation ``cut`` applied; each edited
    line must appear exactly once."""
    target, edits = ABLATIONS[cut]
    if target != source:
        raise ValueError(f"ablation {cut} edits {target}, not {source}")
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"{source}: no single line for ablation {cut}")
        text = text.replace(old, new)
    return text


def _copy_tree(trees, base: str, name: str) -> Path:
    root = Path(__file__).resolve().parents[3]
    dst = root / "build" / "exp" / f"cmp-{name}"
    shutil.rmtree(dst / "src", ignore_errors=True)
    shutil.copytree(trees[base] / "src", dst / "src",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return dst


def _versions(args) -> dict:
    trees = {}
    for spec in args.tree:
        name, path = spec.split("=", 1)
        trees[name] = Path(path).resolve()
    for spec in args.flash:
        name, rest = spec.split("=", 1)
        base, cu, *cut = rest.split(":")
        text = Path(cu).read_text()
        for c in cut:
            text = ablate(text, "flash_attention.cu", c)
        dst = _copy_tree(trees, base, name)
        (dst / "src/repro_torch/kernels/csrc/flash_attention.cu").write_text(
            text)
        trees[name] = dst
    for spec in args.ablate:
        name, rest = spec.split("=", 1)
        base, *cuts = rest.split(":")
        edits = {}
        for c in cuts:
            source = ABLATIONS[c][0]
            text = edits.get(source) or (
                trees[base] / "src/repro_torch/kernels/csrc" / source
            ).read_text()
            edits[source] = ablate(text, source, c)
        dst = _copy_tree(trees, base, name)
        for source, text in edits.items():
            (dst / "src/repro_torch/kernels/csrc" / source).write_text(text)
        trees[name] = dst
    return trees


def kernel_ms(torch, fn, n: int = 5) -> dict:
    """The device time per call of each kernel that ``fn`` launches, by
    name, from ``torch.profiler`` over ``n`` calls after one untimed."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        ms = float(getattr(e, "self_device_time_total", 0.0)) / 1e3 / n
        if ms > 0:
            out[e.key[:80]] = out.get(e.key[:80], 0.0) + ms
    return out


def graph_ms(torch, fn, n: int = 100) -> float:
    """Device time of one call of ``fn`` alone: the call captured in a CUDA
    graph, replayed ``n`` times between two events (no host work)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    for _ in range(5):
        graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


# E-step shapes of the main path: the client call, the cohort, one fit
ESTEP_SWEEP = {"main": (1, 10, 1000, 10, 1280),
               "cohort": (4, 40, 1000, 10, 1280),
               "single": (1, 1, 1000, 10, 1280)}


def sweep_estep_plans(out: Path) -> None:
    """Every E-step plan that ``gmm_estep.launch_plan`` may pick, timed on
    the card (``graph_ms``, prep kernel included) at ``ESTEP_SWEEP``'s
    shapes, each checked against the plain version; one JSON line a plan,
    then the rank of the plan the wrapper picks."""
    import itertools

    import torch
    from repro_torch.kernels import checks, ref
    from repro_torch.kernels import gmm_estep as GE

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    pick = GE.launch_plan
    with out.open("w") as f:
        for tag, shape in ESTEP_SWEEP.items():
            # each case's inputs from seed 0: the same in every version
            g.manual_seed(0)  # lint: disable=KEY-REUSE
            args = checks.estep_inputs(g, dev, *shape)
            elp, _ = ref.estep_fused_ref(*args)
            chosen, rows = pick(*shape), []
            for splits, fits, slots in itertools.product(
                    GE.SPLITS, (1, 2, 4, 8, 16), range(1, 17)):
                plan = GE.Plan(chosen.k_tile, splits, fits, slots)
                if plan.threads % 32 or plan.threads > GE.MAX_THREADS \
                        or fits > shape[1] // shape[0] \
                        or plan.smem_bytes() > GE.MAX_SMEM:
                    continue
                GE.launch_plan = lambda *a, p=plan: p
                try:
                    lp, _ = GE.estep_fused(*args)
                    err = float((lp - elp).abs().max())
                    ms = graph_ms(torch, lambda: GE.estep_fused(*args), 50)
                finally:
                    GE.launch_plan = pick
                gx, gy = plan.grid(*shape[:3])
                rows.append(dict(case=tag, plan=plan._asdict(),
                                 threads=plan.threads, blocks=gx * gy,
                                 graph_ms=ms, max_abs_err=err,
                                 picked=plan == chosen))
            rows.sort(key=lambda r: r["graph_ms"])
            for rank, r in enumerate(rows):
                r["rank"] = rank
                f.write(json.dumps(r) + "\n")
            best = rows[0]
            mine = next(r for r in rows if r["picked"])
            print(json.dumps({"case": tag, "plans": len(rows),
                              "best": best, "picked": mine}), flush=True)


def sweep_cached_splits(out: Path) -> None:
    """Every key split of bf16 ``attention_cached`` at the check shapes
    (``checks.CACHED_CASES``), timed on the card (``graph_ms``) and checked
    against the plain version; one JSON line a plan, then per case the
    best and the one ``split_plan`` picks."""
    import torch
    from repro_torch.kernels import attention_cached as CA
    from repro_torch.kernels import checks, ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    pick = CA.split_plan
    n_sm = CA._sm_count(torch.cuda.current_device())
    with out.open("w") as f:
        for tag, case in checks.CACHED_CASES.items():
            B, H, Hkv, Sq, Sk, D, window, kind = case
            # each case's inputs from seed 0: the same in every version
            g.manual_seed(0)  # lint: disable=KEY-REUSE
            q, k, v, qp, kp = checks.cached_inputs(g, dev, *case,
                                                   dtype=torch.bfloat16)
            n_keys = kp.shape[1]
            tiles = -(-n_keys // CA.BK)
            chosen = pick(B, H, Hkv, Sq, n_keys, n_sm)
            sel = ref.positions_mask(qp, kp, window=window).any(-1)[
                :, None, :].expand(q.shape[:3])
            exp = ref.attention_positions_ref(q, k, v, qp, kp, window=window)

            def call():
                return CA.attention_cached(q, k, v, qp, kp, window=window)
            rows = []
            pers = {-(-tiles // n) for n in range(1, tiles + 1)}
            for per in sorted(pers | {chosen[0] // CA.BK}):
                plan = (per * CA.BK, -(-tiles // per))
                CA.split_plan = lambda *a, p=plan: p
                try:
                    err = float((call().float() - exp.float())[sel].abs()
                                .max())
                    ms = graph_ms(torch, call, 50)
                finally:
                    CA.split_plan = pick
                rows.append(dict(case=tag, keys_per_split=plan[0],
                                 n_split=plan[1], graph_ms=ms,
                                 max_abs_err=err, picked=plan == chosen))
            rows.sort(key=lambda r: r["graph_ms"])
            for r in rows:
                f.write(json.dumps(r) + "\n")
            print(json.dumps({"case": tag, "best": rows[0], "picked": next(
                r for r in rows if r["picked"])}), flush=True)


def summarize(rows, order) -> dict:
    """Per version and kernel, each time of every round (the kernel's and,
    as ``library_*``, its yardstick's), over the kernels its rows hold."""
    out = {}
    for name in order:
        kernels = {}
        for r in rows:
            if r["version"] != name:
                continue
            for k, v in r.items():
                if not (isinstance(v, dict) and "device_ms" in v):
                    continue
                times = kernels.setdefault(k, {})
                for m in ("single_ms", "device_ms", "graph_ms"):
                    if m in v:
                        times.setdefault(m, []).append(v[m])
                    if m in v.get("library", {}):
                        times.setdefault(f"library_{m}", []).append(
                            v["library"][m])
        out[name] = kernels
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", action="append", default=[])
    ap.add_argument("--flash", action="append", default=[])
    ap.add_argument("--ablate", action="append", default=[])
    ap.add_argument("--sweep-estep", action="store_true",
                    help="time every E-step plan at the main path's shapes")
    ap.add_argument("--sweep-cached", action="store_true",
                    help="time every key split of attention_cached at its "
                         "check shapes")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--only", default="",
                    help="comma-separated groups of " + ", ".join(GROUPS))
    ap.add_argument("--out", default="build/compare.jsonl")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.child, args.only)), flush=True)
        return 0
    if args.sweep_estep or args.sweep_cached:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        (sweep_estep_plans if args.sweep_estep else sweep_cached_splits)(out)
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
        summary = {"card": card, "summary": summarize(rows, order)}
        print(json.dumps(summary), flush=True)
        f.write(json.dumps(summary) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
