"""Build the CUDA kernels at first use and bind them with ``ctypes``.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, under ``build/kernels/`` at the
root of the checkout, named by a hash of its source, the shared ``.cuh``
headers and the flags, so a changed source rebuilds and an unchanged one
loads.  Nothing here runs at
import time: the CPU tests import every module and have no ``nvcc``.  A
failed build raises; there is no fallback to the plain version.

Every source includes ``csrc/launch_plan.cuh``: inside :func:`planning`
its launch function records each kernel instance it would launch (grid,
block, shared memory, registers, spills, blocks an SM) instead of
launching it, so the wrappers run unchanged and report their own
geometry (``analysis/pallas_rules.py`` checks it against the card).
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterator, List, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

SOURCES = ("gmm_estep.cu", "flash_attention.cu", "wkv6.cu", "ssd.cu",
           "attention_cached.cu", "flash_attention_bwd.cu", "wkv6_bwd.cu",
           "ssd_bwd.cu", "rms_norm.cu")

_LIBS: Dict[str, ctypes.CDLL] = {}
_PLANNING: List[List[dict]] = []
_PLAN_CAP = 64             # instances one source may record in a plan


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "src/repro_torch/kernels/csrc at first use on a "
                       "machine with the CUDA toolkit")


def _target(source: str) -> Path:
    h = hashlib.sha256((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build(sources: Sequence[str]) -> Dict[str, str]:
    """Compile every source not yet built, one ``nvcc`` each, all at once.

    Returns ``{source: ptxas report}`` for the sources compiled by this
    call (registers, shared memory and spills per kernel).
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [s for s in sources if not _target(s).exists()]
    procs: List = []
    nvcc = _nvcc() if todo else ""
    for s in todo:
        tmp = _target(s).with_suffix(f".{os.getpid()}.tmp")
        procs.append((s, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / s)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    reports, failed = {}, []
    for s, tmp, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{s}:\n{out}")
            continue
        os.replace(tmp, _target(s))
        reports[s] = out
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return reports


def _kernel_name(mangled: str) -> str:
    """``name<arg>`` of a mangled kernel symbol: the last identifier of its
    (possibly nested, length-prefixed) name and its first template argument
    (an int, or ``bf16`` / ``f32``)."""
    pos = 3 if mangled.startswith("_ZN") else 2
    name = ""
    while True:
        m = re.match(r"\d+", mangled[pos:])
        if m is None:
            break
        start = pos + m.end()
        pos = start + int(m.group())
        name = mangled[start:pos]
    if not name:
        return mangled
    t = re.match(r"I(?:Li(\d+)E|(f)E|13__nv_(bfloat16))", mangled[pos:])
    if t is None:
        return name
    return f"{name}<{t.group(1) or ('f32' if t.group(2) else 'bf16')}>"


def ptxas_summary(report: str) -> List[str]:
    """One line per kernel of a ``-Xptxas -v`` report: its name (and
    template argument), registers and spills."""
    out: List[str] = []
    name, parts = None, []
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            if name:
                out.append(f"{name}: " + "; ".join(parts))
            name, parts = _kernel_name(m.group(1)), []
        elif name and ("registers" in ln or "spill" in ln):
            parts.append(ln.replace("ptxas info    :", "").strip())
    if name:
        out.append(f"{name}: " + "; ".join(parts))
    return out


def load(source: str) -> ctypes.CDLL:
    """The shared library of one ``csrc`` source, built if needed."""
    if source not in _LIBS:
        build([source])
        _LIBS[source] = ctypes.CDLL(str(_target(source)))
    return _LIBS[source]


def check(status: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launch function."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{status}")


def count(table: Dict[str, int], name: str) -> None:
    """Add a launch of ``name`` to a wrapper's ``LAUNCHES`` table; a call
    made inside :func:`planning` launched nothing and is not counted."""
    if not _PLANNING:
        table[name] += 1


class PlanInstance(ctypes.Structure):
    """``PlanInstance`` of ``csrc/launch_plan.cuh``."""
    _fields_ = [("name", ctypes.c_char * 160),
                ("grid", ctypes.c_int * 3), ("block", ctypes.c_int * 3),
                ("dyn_smem", ctypes.c_longlong),
                ("cover_extent", ctypes.c_longlong * 3),
                ("cover_tile", ctypes.c_longlong * 3),
                ("static_smem", ctypes.c_int), ("regs", ctypes.c_int),
                ("local_bytes", ctypes.c_int), ("max_threads", ctypes.c_int),
                ("max_dyn_smem", ctypes.c_int),
                ("blocks_per_sm", ctypes.c_int), ("status", ctypes.c_int)]

    def as_dict(self, source: str) -> dict:
        raw = self.name.decode(errors="replace")
        return {"source": source, "kernel": _kernel_name(raw)
                if raw.startswith("_Z") else raw.strip("()"),
                "grid": tuple(self.grid), "block": tuple(self.block),
                "dyn_smem": int(self.dyn_smem),
                "cover": tuple((int(e), int(t)) for e, t in
                               zip(self.cover_extent, self.cover_tile)),
                "static_smem": int(self.static_smem), "regs": int(self.regs),
                "local_bytes": int(self.local_bytes),
                "max_threads": int(self.max_threads),
                "max_dyn_smem": int(self.max_dyn_smem),
                "blocks_per_sm": int(self.blocks_per_sm),
                "status": int(self.status)}


@contextlib.contextmanager
def planning(sources: Sequence[str] = SOURCES) -> Iterator[List[dict]]:
    """Inside the block no kernel of ``sources`` launches: each launch
    function records the instances it would launch, and the block's list
    receives them (``PlanInstance.as_dict``) when it exits.  Wrappers
    called inside run their checks and allocations as always, and count
    no launch.  Every library armed is disarmed on the way out, whatever
    raised."""
    plan: List[dict] = []
    armed = []
    _PLANNING.append(plan)
    try:
        for s in sources:
            lib = load(s)
            lib.launch_plan_begin.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.launch_plan_end.argtypes = []
            buf = (PlanInstance * _PLAN_CAP)()
            lib.launch_plan_begin(ctypes.addressof(buf), _PLAN_CAP)
            armed.append((s, lib, buf))
        yield plan
    finally:
        _PLANNING.remove(plan)
        counts = [(s, lib.launch_plan_end(), buf) for s, lib, buf in armed]
    for s, n, buf in counts:
        if n > _PLAN_CAP:
            raise RuntimeError(f"planning: {s} recorded {n} instances, more "
                               f"than {_PLAN_CAP}")
        plan.extend(buf[i].as_dict(s) for i in range(n))
