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
