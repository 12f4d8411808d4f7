"""Build the CUDA kernels at first use and bind them with ``ctypes``.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, under ``build/kernels/`` at the
root of the checkout, named by a hash of its source, the shared ``.cuh``
headers and the flags, so a changed source rebuilds and an unchanged one
loads.  Nothing here runs at
import time: the CPU tests import every module and have no ``nvcc``.  A
failed build raises; there is no fallback to the plain version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


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
