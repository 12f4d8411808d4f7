"""The Mamba2 SSD recurrence's backward on the card: wrapper of
``csrc/ssd_bwd.cu``, and the autograd ``SSD``.

No TPU kernel answers to it: the reference differentiates its XLA
``ssd_chunked`` by autodiff.  ``SSD.forward`` launches the ``ssd`` kernel
and saves its inputs; ``backward`` launches this kernel: a reverse sweep
carrying the state's gradient (dx, dS0, each head's dB), a forward sweep
carrying the state (each head's dC, and da by a prefix sum), then the
heads' dB and dC summed in a fixed order, all on the CUDA cores, with
every decay factor ≤ 1; the sweeps accumulate in f32 for bf16 inputs and
in f64 for f32 inputs (the prefix sum cancels where the decay is strong).
See the note at the top of the ``.cu`` file for the design.

Takes CUDA tensors only; on the CPU, autograd differentiates
``ref.ssd_ref`` and ``ref.ssd_bwd_ref`` states the formulas.
``LAUNCHES`` counts calls of the backward (four kernels each).
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ssd as _ssd
from repro_torch.kernels.flash_attention_bwd import grad_like
from repro_torch.kernels.wkv6_bwd import ACC_DTYPES

_SOURCE = "ssd_bwd.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES: Dict[str, int] = {"ssd_bwd": 0}
_FN = None


def _launch_fn():
    global _FN
    if _FN is None:
        fn = _build.load(_SOURCE).ssd_bwd_launch
        fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def ssd_bwd(x: torch.Tensor, a_log: torch.Tensor, B: torch.Tensor,
            C: torch.Tensor, s0: torch.Tensor, dy: torch.Tensor, dS_T=None):
    """(dx, da_log, dB, dC, dS0) of ``ssd(x, a_log, B, C, s0)`` at output
    gradient ``dy`` (Bt, H, T, P) and final-state gradient ``dS_T``
    (Bt, H, N, P), None for zero.  dx in x's dtype, a (Bt, H, T, P) view of
    a (Bt, T, H, P) tensor; da_log (Bt, H, T) f32; dB, dC (Bt, T, N) in x's
    dtype, summed over the heads; dS0 f32.

    x, B, C and dy take any strides whose last dimension is contiguous (a
    ``dy`` that is not is copied first) and a_log any strides; dy is in
    x's dtype, a_log is read as f32.
    """
    if dy.dim() == 4 and dy.stride(-1) != 1:
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
                         f"{list(_DTYPES)}, got {x.dtype}, {B.dtype}, "
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
    s0 = s0.float().contiguous()
    if dS_T is not None:
        dS_T = dS_T.float().contiguous()
    f32 = dict(dtype=torch.float32, device=dev)
    dx = grad_like(x)
    da = torch.empty((Bt, H, T), **f32)
    dB = torch.empty((Bt, T, N), dtype=x.dtype, device=dev)
    dC = torch.empty((Bt, T, N), dtype=x.dtype, device=dev)
    ds0 = torch.empty((Bt, H, N, P), **f32)
    dBh = torch.empty((Bt, H, T, N), **f32)     # each head's share of dB
    dCh = torch.empty((Bt, H, T, N), **f32)     # and of dC
    acc = dict(dtype=ACC_DTYPES[x.dtype], device=dev)
    xdx = torch.empty((Bt, H, T), **acc)        # x·dx, launch 1 → 2
    c0 = torch.empty((Bt, H), **acc)            # ⟨s0, dS0⟩
    st = [*x.stride()[:3], *a_log.stride(), B.stride(0), 0, B.stride(1),
          C.stride(0), 0, C.stride(1), *dy.stride()[:3], *dx.stride()[:3]]
    strides = (ctypes.c_longlong * 18)(*st)
    status = _launch_fn()(
        x.data_ptr(), a_log.data_ptr(), B.data_ptr(), C.data_ptr(),
        s0.data_ptr(), dy.data_ptr(),
        dS_T.data_ptr() if dS_T is not None else None, dx.data_ptr(),
        da.data_ptr(), dB.data_ptr(), dC.data_ptr(), ds0.data_ptr(),
        dBh.data_ptr(), dCh.data_ptr(), xdx.data_ptr(), c0.data_ptr(),
        ctypes.addressof(strides),
        _DTYPES[x.dtype], Bt, H, T, N, P,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "ssd_bwd_launch")
    LAUNCHES["ssd_bwd"] += 1
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
