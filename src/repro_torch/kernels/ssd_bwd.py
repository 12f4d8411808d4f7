"""The Mamba2 SSD recurrence's backward on the card: wrapper of
``csrc/ssd_bwd.cu``, and the autograd ``SSD``.

No TPU kernel answers to it: the reference differentiates its XLA
``ssd_chunked`` by autodiff.  ``SSD.forward`` launches the ``ssd`` kernel
and saves its inputs; ``backward`` launches this kernel.  bf16 inputs take
the chunked form on the tensor cores, chunks of 64 steps in parallel: each
chunk's own state contributions, a scan over the chunks for the boundary
states, then every chunk's gradients for a group of eight heads (da by a
prefix sum re-anchored at each chunk), and the groups' dB and dC summed in
a fixed order (five launches).  f32 inputs take two step sweeps on the
CUDA cores accumulating in f64 (four launches).  See the note at the top
of the ``.cu`` file for the designs.

Takes CUDA tensors only; on the CPU, autograd differentiates
``ref.ssd_ref`` and ``ref.ssd_bwd_ref`` states the formulas.
``LAUNCHES`` counts calls of the backward.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ssd as _ssd
from repro_torch.kernels.flash_attention_bwd import grad_like
from repro_torch.kernels.wkv6_bwd import CHUNK, aligned

_SOURCE = "ssd_bwd.cu"
_DTYPES = (torch.float32, torch.bfloat16)
HEAD_GROUP = 8      # heads per block of the bf16 route's third launch

LAUNCHES: Dict[str, int] = {"ssd_bwd": 0}


def _fn(name: str, n_ptr: int):
    fn = getattr(_build.load(_SOURCE), name)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ssd_bwd(x: torch.Tensor, a_log: torch.Tensor, B: torch.Tensor,
            C: torch.Tensor, s0: torch.Tensor, dy: torch.Tensor, dS_T=None):
    """(dx, da_log, dB, dC, dS0) of ``ssd(x, a_log, B, C, s0)`` at output
    gradient ``dy`` (Bt, H, T, P) and final-state gradient ``dS_T``
    (Bt, H, N, P), None for zero.  dx in x's dtype, a (Bt, H, T, P) view of
    a (Bt, T, H, P) tensor; da_log (Bt, H, T) f32; dB, dC (Bt, T, N) in x's
    dtype, summed over the heads; dS0 f32.

    x, B, C and dy take any strides whose last dimension is contiguous (a
    ``dy`` that is not is copied first; bf16: 16-byte aligned rows of x,
    8-byte of B and C at N = 4, and a ``dy`` without them is copied) and
    a_log any strides; dy is in x's dtype, a_log is read as f32.
    """
    if dy.dim() == 4 and (dy.stride(-1) != 1 or (
            dy.dtype == torch.bfloat16 and not aligned(dy))):
        dy = dy.contiguous()
    dev = x.device
    for name, t in (("x", x), ("a_log", a_log), ("B", B), ("C", C),
                    ("s0", s0), ("dy", dy)) + (
                        (("dS_T", dS_T),) if dS_T is not None else ()):
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"ssd_bwd: {name} must be a CUDA tensor on "
                             f"{dev}, got {t.device}")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in (B, C, dy)):
        raise ValueError(f"ssd_bwd: x, B, C, dy must share one of "
                         f"{_DTYPES}, got {x.dtype}, {B.dtype}, "
                         f"{C.dtype}, {dy.dtype}")
    if x.dim() != 4:
        raise ValueError(f"ssd_bwd: x must be (Bt, H, T, P), got "
                         f"{tuple(x.shape)}")
    Bt, H, T, P = x.shape
    N = B.shape[-1]
    if a_log.shape != (Bt, H, T) or B.shape != (Bt, T, N) \
            or C.shape != B.shape or s0.shape != (Bt, H, N, P) \
            or dy.shape != x.shape or (dS_T is not None
                                       and dS_T.shape != s0.shape):
        raise ValueError(f"ssd_bwd: shapes x {tuple(x.shape)}, a_log "
                         f"{tuple(a_log.shape)}, B {tuple(B.shape)}, C "
                         f"{tuple(C.shape)}, s0 {tuple(s0.shape)}, dy "
                         f"{tuple(dy.shape)} do not agree")
    for name, t in (("x", x), ("B", B), ("C", C), ("dy", dy)):
        if t.stride(-1) != 1:
            raise ValueError(f"ssd_bwd: {name} needs a contiguous last dim,"
                             f" got strides {t.stride()}")
    if N not in _ssd.STATE_DIMS or P % 8 or not 8 <= P <= _ssd.MAX_HEAD_DIM \
            or min(Bt, H, T) < 1:
        raise ValueError(f"ssd_bwd: need N in {_ssd.STATE_DIMS}, P a multiple"
                         f" of 8 up to {_ssd.MAX_HEAD_DIM}, Bt, H, T ≥ 1; got"
                         f" N={N}, x {tuple(x.shape)}")
    a_log = a_log.float()
    bf16 = x.dtype == torch.bfloat16
    if bf16:
        for name, t in (("x", x), ("B", B), ("C", C)):
            if not (aligned(t) if t.shape[-1] % 8 == 0 else
                    t.data_ptr() % 8 == 0 and all(
                        st % 4 == 0 for st in t.stride()[:-1])):
                raise ValueError(f"ssd_bwd: {name} needs a 16-byte (8 at N ="
                                 f" 4) aligned base and strides, got pointer"
                                 f" {t.data_ptr():#x} strides {t.stride()}")
    s0 = s0.float().contiguous()
    if dS_T is not None:
        dS_T = dS_T.float().contiguous()
    f32 = dict(dtype=torch.float32, device=dev)
    dx = grad_like(x)
    da = torch.empty((Bt, H, T), **f32)
    dB = torch.empty((Bt, T, N), dtype=x.dtype, device=dev)
    dC = torch.empty((Bt, T, N), dtype=x.dtype, device=dev)
    ds0 = torch.empty((Bt, H, N, P), **f32)
    st = [*x.stride()[:3], *a_log.stride(), B.stride(0), 0, B.stride(1),
          C.stride(0), 0, C.stride(1), *dy.stride()[:3], *dx.stride()[:3]]
    strides = (ctypes.c_longlong * 18)(*st)
    ptrs = [x.data_ptr(), a_log.data_ptr(), B.data_ptr(), C.data_ptr(),
            s0.data_ptr(), dy.data_ptr(),
            dS_T.data_ptr() if dS_T is not None else None, dx.data_ptr(),
            da.data_ptr(), dB.data_ptr(), dC.data_ptr(), ds0.data_ptr()]
    if bf16:
        nc, groups = -(-T // CHUNK), -(-H // HEAD_GROUP)
        # each chunk's dS then S0, its dG then Gx; its cwl; da at its
        # first step; each group of heads' share of dB and of dC
        scratch = [torch.empty((Bt, H, nc, 64, 64), **f32),
                   torch.empty((Bt, H, nc, 64, 64), **f32),
                   torch.empty((Bt, H, nc), **f32),
                   torch.empty((Bt, H, nc), **f32),
                   torch.empty((Bt, groups, T, N), **f32),
                   torch.empty((Bt, groups, T, N), **f32)]
        name = "ssd_bwd_chunked_launch"
    else:
        f64 = dict(dtype=torch.float64, device=dev)
        scratch = [torch.empty((Bt, H, T, N), **f32),   # each head's dB
                   torch.empty((Bt, H, T, N), **f32),   # and dC
                   torch.empty((Bt, H, T), **f64),      # x·dx, launch 1 → 2
                   torch.empty((Bt, H), **f64)]         # ⟨s0, dS0⟩
        name = "ssd_bwd_launch"
    ptrs += [t.data_ptr() for t in scratch]
    status = _fn(name, len(ptrs) + 1)(
        *ptrs, ctypes.addressof(strides), Bt, H, T, N, P,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, name)
    _build.count(LAUNCHES, "ssd_bwd")
    return dx, da, dB, dC, ds0


class SSD(torch.autograd.Function):
    """The SSD recurrence with a gradient: the ``ssd`` kernel forward and
    this backward kernel, both hand-written.  Returns (y, final state);
    autograd hands the backward zeros for an output that took no
    gradient."""

    @staticmethod
    def forward(ctx, x, a_log, B, C, s0, chunk: int):
        y, S = _ssd.ssd(x, a_log, B, C, s0, chunk=chunk)
        ctx.save_for_backward(x, a_log, B, C, s0)
        return y, S

    @staticmethod
    def backward(ctx, dy, dS_T):
        return (*ssd_bwd(*ctx.saved_tensors, dy, dS_T), None)
