"""CUDA-*: the Hopper launch contract of the hand-written kernels (port of
``repro/analysis/pallas_rules.py``; the file keeps its name so that its
counterpart is easy to find).

The reference records each ``pallas_call``'s grid and BlockSpecs under
``eval_shape``.  Here every source under ``kernels/csrc`` routes its
launches through ``csrc/launch_plan.cuh``: inside
``kernels._build.planning`` the wrappers run as they always do, and each
launch function records, instead of launching, every kernel instance it
would launch for that call's shapes — its grid, block, dynamic shared
memory and the operand extent each grid axis must cover (``COVER``), with
``cudaFuncGetAttributes`` (registers, static shared memory, local bytes)
and ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``.  The plan is the
launch's own code path, so the geometry checked is the geometry launched;
nothing of the C++ tiling is restated here.

Checks per recorded instance (:func:`check_launch`, pure):

* **CUDA-SMEM** (ERROR) — static + dynamic shared memory above the
  Hopper limit of 227 KiB (232 448 B) a block: the launch fails at that
  shape (PAL-VMEM's counterpart).
* **CUDA-OCC** (ERROR) — zero blocks fit an SM (registers, threads or
  shared memory), or a block of more threads than the kernel allows.
* **CUDA-GRID** (ERROR) — grid.y or grid.z above 65 535 (grid.x above
  2³¹ − 1), or a grid axis whose blocks × tile fail to cover the operand
  extent stated by ``COVER``: dropped rows (PAL-DIV's counterpart).  A
  probe whose wrapper refuses its shape lands here too.
* **CUDA-SPILL** — local memory: WARN on a bf16 tensor-core route, INFO
  on the f32 CUDA-core routes, whose spills are known and documented,
  and on the two bf16 instances of ``KNOWN_SPILLS`` up to their
  documented bytes.

The probe grid is the reference's E-step and flash probes plus the dry
run's long shapes (flash at S 32 768, its backward at D = 160 and 192,
``attention_cached`` over 32 768 keys and a ring of 8192, ``wkv6`` /
``ssd`` at T 32 768 and their backwards at 4096), and small f32 shapes
for the CUDA-core routes; ``rms_norm`` at the main paths' rows, at
nemotron-4-340b's width in f32 and at an odd width.  Without a card (``device="cpu"``) the rule
emits one INFO finding per source saying it was not checked.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.core import (Finding, SemanticRule, Severity,
                                       SourceFile)

SMEM_LIMIT_BYTES = 232448          # 227 KiB a block (sm_90)
MAX_GRID_YZ = 65535
MAX_GRID_X = 2 ** 31 - 1

# bf16 tensor-core instances whose local memory is known and documented
# (PERF.md §6, ROADMAP): local bytes a thread, as cudaFuncGetAttributes
# gives them.  Both hold 168 registers to fit three blocks an SM
# (__launch_bounds__(128, 3)); ptxas spills 4 B (flash, D = 128, 8 B of
# stack) and 64 B (ssd, N = 64) to meet it.  More local memory than listed
# here, or local memory on another bf16 instance, warns.
KNOWN_SPILLS = {"flash_mma_kernel<128>": 8, "ssd_mma_kernel<64>": 64}

# source → the wrapper module that a finding lands on
WRAPPERS = {
    "gmm_estep.cu": "repro_torch/kernels/gmm_estep.py",
    "flash_attention.cu": "repro_torch/kernels/flash_attention.py",
    "flash_attention_bwd.cu": "repro_torch/kernels/flash_attention_bwd.py",
    "attention_cached.cu": "repro_torch/kernels/attention_cached.py",
    "wkv6.cu": "repro_torch/kernels/wkv6.py",
    "wkv6_bwd.cu": "repro_torch/kernels/wkv6_bwd.py",
    "ssd.cu": "repro_torch/kernels/ssd.py",
    "ssd_bwd.cu": "repro_torch/kernels/ssd_bwd.py",
    "rms_norm.cu": "repro_torch/kernels/rms_norm.py",
}


@dataclasses.dataclass(frozen=True)
class KernelProbe:
    """One wrapper call at one geometry: ``call(device)`` runs it (inside
    ``_build.planning``, so nothing launches).  ``route`` is ``bf16`` (the
    tensor-core kernels) or ``f32`` (the CUDA-core ones)."""
    name: str
    source: str
    route: str
    call: Callable[[str], None]


def check_launch(plan: dict, attrs: dict
                 ) -> List[Tuple[str, Severity, str]]:
    """Pure checks over one kernel instance → [(rule, severity, message)].

    ``plan``: ``kernel``, ``grid`` (3), ``block`` (3), ``dyn_smem``,
    ``cover`` (3 pairs of (extent, per block); extent 0: none stated) and
    ``route`` (``bf16`` / ``f32``).  ``attrs``: ``static_smem``, ``regs``,
    ``local_bytes``, ``max_threads``, ``blocks_per_sm`` and ``status``
    (the queries' ``cudaError_t``).
    """
    out: List[Tuple[str, Severity, str]] = []
    name = plan.get("kernel", "?")
    grid, block = tuple(plan["grid"]), tuple(plan["block"])
    smem = int(attrs.get("static_smem", 0)) + int(plan.get("dyn_smem", 0))
    if smem > SMEM_LIMIT_BYTES:
        out.append(("CUDA-SMEM", Severity.ERROR,
                    f"'{name}' needs {smem} B of shared memory a block "
                    f"({attrs.get('static_smem', 0)} static + "
                    f"{plan.get('dyn_smem', 0)} dynamic), above the "
                    f"{SMEM_LIMIT_BYTES} B an SM of the H100 gives a block"))
    threads = block[0] * block[1] * block[2]
    if attrs.get("status", 0):
        out.append(("CUDA-OCC", Severity.ERROR,
                    f"'{name}': the attribute / occupancy query failed "
                    f"with cudaError_t {attrs['status']}"))
    elif int(attrs.get("blocks_per_sm", 0)) < 1:
        out.append(("CUDA-OCC", Severity.ERROR,
                    f"'{name}': no block of {threads} threads and {smem} B "
                    f"of shared memory fits an SM ({attrs.get('regs', 0)} "
                    f"registers a thread)"))
    if attrs.get("max_threads") and threads > attrs["max_threads"]:
        out.append(("CUDA-OCC", Severity.ERROR,
                    f"'{name}': {threads} threads a block, the kernel "
                    f"allows {attrs['max_threads']}"))
    if min(grid) < 1 or grid[0] > MAX_GRID_X or grid[1] > MAX_GRID_YZ \
            or grid[2] > MAX_GRID_YZ:
        out.append(("CUDA-GRID", Severity.ERROR,
                    f"'{name}': grid {grid} is outside (1…2³¹−1, 1…65535, "
                    f"1…65535)"))
    for axis, (extent, tile) in enumerate(plan.get("cover", ())):
        if extent > 0 and grid[axis] * tile < extent:
            out.append(("CUDA-GRID", Severity.ERROR,
                        f"'{name}': grid axis {axis} has {grid[axis]} "
                        f"blocks of {tile}, short of the operand extent "
                        f"{extent}: rows are dropped"))
    local = int(attrs.get("local_bytes", 0))
    if local > 0:
        known = plan.get("route") != "bf16" or \
            local <= KNOWN_SPILLS.get(name, 0)
        why = ": a known f32 CUDA-core spill" \
            if plan.get("route") != "bf16" else \
            ": a known spill (KNOWN_SPILLS)" if known else ""
        out.append(("CUDA-SPILL", Severity.INFO if known else Severity.WARN,
                    f"'{name}' ({plan.get('route')}) uses {local} B of "
                    f"local memory a thread ({attrs.get('regs', 0)} "
                    f"registers){why}"))
    return out


# ---------------------------------------------------------------------------
# probes
# ---------------------------------------------------------------------------


def _t(shape, dtype: str, device: str, fill: float = 0.0):
    import torch
    return torch.full(shape, fill, dtype=getattr(torch, dtype),
                      device=device)


def _estep(B, N, K, d, fused=True):
    def call(dev):
        from repro_torch.kernels import gmm_estep as GE
        x = _t((B, N, d), "float32", dev)
        mu = _t((B, K, d), "float32", dev)
        var = _t((B, K, d), "float32", dev, 1.0)
        pi = _t((B, K), "float32", dev, 1.0 / K)
        if fused:
            GE.estep_fused(x, mu, var, pi)
        else:
            GE.estep(x[0], mu[0], var[0], pi[0])
    return call


def _flash(B, H, Hkv, Sq, Sk, D, dtype, bwd=False, **mask):
    def call(dev):
        from repro_torch.kernels import flash_attention as FA
        from repro_torch.kernels import flash_attention_bwd as FAB
        q = _t((B, H, Sq, D), dtype, dev)
        k = _t((B, Hkv, Sk, D), dtype, dev)
        if not bwd:
            FA.flash_attention(q, k, k, **mask)
            return
        lse = _t((B, H, Sq), "float32", dev)
        FAB.flash_attention_bwd(q, k, k, q, lse, q, **mask)
    return call


def _cached(B, H, Hkv, Sq, Sk, D, dtype, ring=False, window=0):
    def call(dev):
        import torch

        from repro_torch.kernels import attention_cached as AC
        q = _t((B, H, Sq, D), dtype, dev)
        k = _t((B, Hkv, Sk, D), dtype, dev)
        start = Sk - Sq if not ring else 3 * Sk
        q_pos = torch.arange(start, start + Sq, device=dev,
                             dtype=torch.int32).expand(B, Sq)
        kv = torch.arange(Sk, device=dev, dtype=torch.int32)
        if ring:          # a wrapped ring: slot i holds position 3Sk + i − Sk
            kv = kv + 2 * Sk
        AC.attention_cached(q, k, k, q_pos, kv.expand(B, Sk).contiguous(),
                            causal=True, window=window)
    return call


def _wkv6(B, H, T, Dh, dtype, bwd=False):
    def call(dev):
        from repro_torch.kernels import wkv6 as W
        from repro_torch.kernels import wkv6_bwd as WB
        r = _t((B, H, T, Dh), dtype, dev)
        lw = _t((B, H, T, Dh), "float32", dev, -0.1)
        u = _t((H, Dh), "float32", dev)
        s0 = _t((B, H, Dh, Dh), "float32", dev)
        if not bwd:
            W.wkv6(r, r, r, lw, u, s0)
            return
        WB.wkv6_bwd(r, r, r, lw, u, s0, r, s0)
    return call


def _ssd(Bt, H, T, N, P, dtype, bwd=False):
    def call(dev):
        from repro_torch.kernels import ssd as S
        from repro_torch.kernels import ssd_bwd as SB
        x = _t((Bt, H, T, P), dtype, dev)
        a = _t((Bt, H, T), "float32", dev, -0.1)
        Bm = _t((Bt, T, N), dtype, dev)
        s0 = _t((Bt, H, N, P), "float32", dev)
        if not bwd:
            S.ssd(x, a, Bm, Bm, s0)
            return
        SB.ssd_bwd(x, a, Bm, Bm, s0, x, s0)
    return call


def _rms_norm(rows, d, dtype, gate=False, z_stride=0):
    def call(dev):
        from repro_torch.kernels import rms_norm as R
        x = _t((rows, d), dtype, dev)
        z = _t((rows, z_stride or d), dtype, dev)[:, :d] if gate else None
        R.rms_norm(x, _t((d,), dtype, dev), z=z)
    return call


def kernel_probes() -> List[KernelProbe]:
    P = KernelProbe
    return [
        # the reference's E-step probes (pallas_rules.py:117-135)
        P("estep_fused[tiny_ragged]", "gmm_estep.cu", "f32",
          _estep(1, 37, 3, 5)),
        P("estep_fused[mid]", "gmm_estep.cu", "f32", _estep(2, 512, 8, 64)),
        P("estep_fused[wide]", "gmm_estep.cu", "f32",
          _estep(1, 4096, 16, 256)),
        P("estep[single]", "gmm_estep.cu", "f32",
          _estep(1, 1000, 4, 64, fused=False)),
        # the reference's flash probes (pallas_rules.py:138-157), then the
        # dry run's prefill at S 32 768
        P("flash[ragged]", "flash_attention.cu", "bf16",
          _flash(1, 4, 2, 200, 200, 64, "bfloat16", causal=True)),
        P("flash[ragged_f32]", "flash_attention.cu", "f32",
          _flash(1, 4, 2, 200, 200, 64, "float32", causal=True)),
        P("flash[train_4k]", "flash_attention.cu", "bf16",
          _flash(1, 4, 2, 4096, 4096, 64, "bfloat16", causal=True)),
        P("flash[decode]", "flash_attention.cu", "bf16",
          _flash(1, 4, 2, 1, 32768, 64, "bfloat16", causal=False)),
        P("flash[prefill_32k]", "flash_attention.cu", "bf16",
          _flash(1, 32, 8, 32768, 32768, 128, "bfloat16", causal=True)),
        # the backward at the wide heads (pixtral-12b D = 160,
        # nemotron-4-340b D = 192) and one f32 CUDA-core shape
        P("flash_bwd[d160]", "flash_attention_bwd.cu", "bf16",
          _flash(1, 32, 8, 1024, 1024, 160, "bfloat16", bwd=True,
                 causal=True)),
        P("flash_bwd[d192]", "flash_attention_bwd.cu", "bf16",
          _flash(1, 96, 8, 1024, 1024, 192, "bfloat16", bwd=True,
                 causal=True)),
        P("flash_bwd[f32_d128]", "flash_attention_bwd.cu", "f32",
          _flash(1, 4, 2, 200, 200, 128, "float32", bwd=True, causal=True)),
        # decode over 32 768 cached keys, a ring of 8192, an f32 prefill
        P("cached[decode_32k]", "attention_cached.cu", "bf16",
          _cached(8, 32, 8, 1, 32768, 128, "bfloat16")),
        P("cached[ring_8192]", "attention_cached.cu", "bf16",
          _cached(8, 32, 8, 1, 8192, 128, "bfloat16", ring=True,
                  window=8192)),
        P("cached[f32_chunk]", "attention_cached.cu", "f32",
          _cached(1, 8, 2, 64, 1024, 64, "float32")),
        # the recurrences at T 32 768 (rwkv6-3b, zamba2-7b heads)
        P("wkv6[T32k]", "wkv6.cu", "bf16", _wkv6(1, 40, 32768, 64,
                                                 "bfloat16")),
        P("wkv6[f32]", "wkv6.cu", "f32", _wkv6(1, 4, 200, 64, "float32")),
        P("ssd[T32k]", "ssd.cu", "bf16", _ssd(1, 112, 32768, 64, 64,
                                              "bfloat16")),
        P("ssd[f32]", "ssd.cu", "f32", _ssd(1, 4, 200, 64, 64, "float32")),
        # their backwards at 4096
        P("wkv6_bwd[T4k]", "wkv6_bwd.cu", "bf16",
          _wkv6(1, 40, 4096, 64, "bfloat16", bwd=True)),
        P("wkv6_bwd[f32]", "wkv6_bwd.cu", "f32",
          _wkv6(1, 4, 200, 64, "float32", bwd=True)),
        P("ssd_bwd[T4k]", "ssd_bwd.cu", "bf16",
          _ssd(1, 112, 4096, 64, 64, "bfloat16", bwd=True)),
        P("ssd_bwd[f32]", "ssd_bwd.cu", "f32",
          _ssd(1, 4, 200, 64, 64, "float32", bwd=True)),
        # the norm at hubert-xlarge's rows, zamba2-7b's gated rows (z a
        # split view of the in-projection), nemotron-4-340b's width in f32
        # (the row in shared memory) and an odd width (one value a load)
        P("rms_norm[d1280]", "rms_norm.cu", "bf16",
          _rms_norm(16384, 1280, "bfloat16")),
        P("rms_norm[gated_d7168]", "rms_norm.cu", "bf16",
          _rms_norm(32768, 7168, "bfloat16", gate=True, z_stride=14576)),
        P("rms_norm[f32_d18432]", "rms_norm.cu", "f32",
          _rms_norm(16, 18432, "float32")),
        P("rms_norm[odd]", "rms_norm.cu", "bf16",
          _rms_norm(5, 1283, "bfloat16")),
    ]


def plan_probe(probe: KernelProbe, device: str) -> List[dict]:
    """The instances ``probe``'s wrapper call would launch (nothing is
    launched), each with its ``probe`` and ``route``."""
    import torch

    from repro_torch.kernels import _build
    with _build.planning([probe.source]) as plan:
        probe.call(device)
    torch.cuda.synchronize()
    return [dict(inst, probe=probe.name, route=probe.route) for inst in plan]


def launch_report(device: str, probes: Optional[Sequence[KernelProbe]]
                  = None) -> Tuple[Dict[str, dict], List[tuple]]:
    """Plan every probe on ``device`` (a card): per source the probes and
    instances checked, the largest shared memory a block, the fewest
    blocks an SM, the instances that spill; and every check's output as
    (source, probe, rule, severity, message)."""
    per: Dict[str, dict] = {}
    issues: List[tuple] = []
    for probe in (kernel_probes() if probes is None else probes):
        st = per.setdefault(probe.source, {
            "probes": 0, "instances": 0, "max_smem": 0,
            "min_blocks_per_sm": None, "spills": []})
        try:
            insts = plan_probe(probe, device)
        except Exception as e:  # noqa: BLE001 — a refused probe is a finding
            issues.append((probe.source, probe.name, "CUDA-GRID",
                           Severity.ERROR, f"the wrapper refused the probe: "
                           f"{type(e).__name__}: {e}"))
            continue
        st["probes"] += 1
        st["instances"] += len(insts)
        if not insts:
            issues.append((probe.source, probe.name, "CUDA-GRID",
                           Severity.ERROR, "the probe recorded no launch"))
        for inst in insts:
            smem = inst["static_smem"] + inst["dyn_smem"]
            st["max_smem"] = max(st["max_smem"], smem)
            occ = inst["blocks_per_sm"]
            st["min_blocks_per_sm"] = occ if st["min_blocks_per_sm"] is None \
                else min(st["min_blocks_per_sm"], occ)
            if inst["local_bytes"]:
                tag = f"{inst['kernel']}: {inst['local_bytes']} B"
                if tag not in st["spills"]:
                    st["spills"].append(tag)
            for rule, sev, msg in check_launch(inst, inst):
                issues.append((probe.source, probe.name, rule, sev, msg))
    return per, issues


class LaunchContractRule(SemanticRule):
    id = "CUDA"        # emits CUDA-SMEM / CUDA-OCC / CUDA-GRID / CUDA-SPILL
    severity = Severity.ERROR
    doc = ("Hopper launch contract of every csrc kernel, from its own "
           "launch plan: shared memory ≤ 227 KiB, ≥ 1 block an SM, grid "
           "limits and coverage, spills")
    reference = "PAL-DIV / PAL-ALIGN / PAL-VMEM"
    hazard = ("a launch that fails, or drops rows, only at the shape where "
              "it runs")
    anchors = tuple(sorted(WRAPPERS.values()))

    def __init__(self, probes: Optional[Sequence[KernelProbe]] = None):
        self.probes = probes
        self.report: Dict[str, dict] = {}

    def run_project(self, files: Sequence[SourceFile], device: str):
        by_source = {s: self.anchor(files, a) for s, a in WRAPPERS.items()}
        by_source = {s: f for s, f in by_source.items() if f is not None}
        findings: List[Finding] = []
        if device == "cpu":
            for s, src in sorted(by_source.items()):
                findings.append(self.finding(
                    src, 1, f"{s}: launch contract not checked — it needs "
                    f"a card (run with --device cuda on an H100)",
                    severity=Severity.INFO, rule="CUDA-SMEM"))
            return findings
        probes = [p for p in (self.probes if self.probes is not None
                              else kernel_probes()) if p.source in by_source]
        self.report, issues = launch_report(device, probes)
        for source, probe, rule, sev, msg in issues:
            findings.append(self.finding(
                by_source[source], 1, f"{source} {probe}: {msg}",
                "change the launch geometry in csrc (COVER states what the "
                "grid must reach)", severity=sev, rule=rule))
        return findings
