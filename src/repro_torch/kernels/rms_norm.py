"""RMS norm of rows, and Mamba2's SiLU-gated norm, on the card: wrapper of
``csrc/rms_norm.cu``.

No TPU kernel: the reference leaves ``rms_norm`` (and ``rms_norm(y, gn) *
silu(z)``) to XLA, which fuses it into one pass over a row.  Eagerly the
plain expression (``ref.rms_norm_ref``) is eight launches and about 40
bytes an element; the kernel reads each row once and writes it once, with
the plain expression's rounding points (see the note at the top of the
``.cu`` file).

The launch plan (:func:`launch_plan`) is a function of the row width, the
row count, the element size and the alignment alone: 16-byte loads where
every pointer and row stride allows them, the fewest threads a row
(a power of two, 32 to 1024) that hold the row in ``CHUNKS`` vectors of
registers each, several rows a block for narrow rows, and shared memory
for a row wider than 1024 threads hold in registers.

Takes CUDA tensors only; ``ops`` sends CPU tensors to
``ref.rms_norm_ref``.  ``LAUNCHES`` counts kernel launches; the
``kernels.rms_norm.rows`` counter of ``repro_torch.obs`` the rows.
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional

import torch

from repro_torch import obs
from repro_torch.kernels import _build

_SOURCE = "rms_norm.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_THREADS = 1024
CHUNKS = 4            # vectors a thread holds in registers (csrc: CH)
BLOCK_THREADS = 256   # a block of several narrow rows
SMS = 132             # H100 SXM

LAUNCHES: Dict[str, int] = {"rms_norm": 0}


class Plan(NamedTuple):
    vec: int          # values a load: 16 bytes' worth, or 1
    tpr: int          # threads a row
    rpb: int          # rows a block
    smem: bool        # the row waits in shared memory (else registers)
    threads: int      # a block's
    blocks: int
    smem_bytes: int   # dynamic shared memory a block


def launch_plan(d: int, rows: int, elem_bytes: int,
                aligned: bool = True) -> Plan:
    """The launch of ``rows`` rows of width ``d`` whose values take
    ``elem_bytes`` (2 bf16, 4 f32); ``aligned``: every pointer and row
    stride is a multiple of 16 bytes.  A width that is no multiple of 16
    bytes' values takes one value a load."""
    wide = 16 // elem_bytes
    vec = wide if aligned and d % wide == 0 else 1
    nvec = d // vec
    tpr = 32
    while tpr < MAX_THREADS and tpr * CHUNKS < nvec:
        tpr *= 2
    smem = nvec > tpr * CHUNKS
    rpb = 1 if smem else max(1, min(BLOCK_THREADS // tpr, -(-rows // SMS)))
    return Plan(vec, tpr, rpb, smem, tpr * rpb, -(-rows // rpb),
                4 * rpb * d if smem else 0)


def _lib() -> ctypes.CDLL:
    lib = _build.load(_SOURCE)
    fn = lib.rms_norm_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_longlong,
                                           ctypes.c_longlong] \
        + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _rows(t: torch.Tensor, d: int) -> torch.Tensor:
    """``t`` as (rows, d) with contiguous rows: a view where its layout
    allows one (a split or transposed activation), else a copy."""
    t2 = t.reshape(-1, d)
    return t2 if t2.stride(1) == 1 else t2.contiguous()


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             z: Optional[torch.Tensor] = None, eps: float = 1e-6
             ) -> torch.Tensor:
    """x: (…, d) f32 or bf16; gamma: (d,) in x's dtype; z: None or x's
    shape and dtype, any strides.  Returns ``ref.rms_norm_ref(x, gamma,
    z, eps)`` (…, d) in x's dtype, contiguous: the norm in f32, rounded
    once, and with ``z`` times silu(z), rounded where the plain expression
    rounds."""
    if x.dtype not in _DTYPES:
        raise ValueError(f"rms_norm: x must be one of {list(_DTYPES)}, got "
                         f"{x.dtype}")
    if x.dim() < 1 or x.shape[-1] < 1:
        raise ValueError(f"rms_norm: x must be (…, d) with d ≥ 1, got "
                         f"{tuple(x.shape)}")
    d = x.shape[-1]
    if gamma.dtype != x.dtype or tuple(gamma.shape) != (d,):
        raise ValueError(f"rms_norm: gamma must be ({d},) {x.dtype}, got "
                         f"{tuple(gamma.shape)} {gamma.dtype}")
    if z is not None and (z.shape != x.shape or z.dtype != x.dtype):
        raise ValueError(f"rms_norm: z must be x's {tuple(x.shape)} "
                         f"{x.dtype}, got {tuple(z.shape)} {z.dtype}")
    for name, t in (("x", x), ("gamma", gamma), ("z", z)):
        if t is not None and (not t.is_cuda or t.device != x.device):
            raise ValueError(f"rms_norm: {name} must be a CUDA tensor on "
                             f"{x.device}, got {t.device}")
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    x2 = _rows(x, d)
    rows = x2.shape[0]
    if rows == 0:
        return out
    gamma = gamma.contiguous()
    z2 = None if z is None else _rows(z, d)
    es = x.element_size()
    ptrs = [t.data_ptr() for t in (x2, gamma, out, z2) if t is not None]
    steps = [x2.stride(0)] + ([] if z2 is None else [z2.stride(0)])
    aligned = all(p % 16 == 0 for p in ptrs) and \
        all((s * es) % 16 == 0 for s in steps)
    plan = launch_plan(d, rows, es, aligned)
    status = _lib().rms_norm_launch(
        x2.data_ptr(), gamma.data_ptr(), None if z2 is None else
        z2.data_ptr(), out.data_ptr(), rows, d, x2.stride(0),
        0 if z2 is None else z2.stride(0), _DTYPES[x.dtype],
        int(plan.vec > 1), plan.tpr, plan.rpb, int(plan.smem), eps,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, "rms_norm_launch")
    _build.count(LAUNCHES, "rms_norm")
    obs.count("kernels.rms_norm.rows", rows)
    return out
