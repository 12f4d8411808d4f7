"""Mamba2 SSD recurrence on the card: wrapper of ``csrc/ssd.cu``.

Port of ``repro/kernels/ssd.py`` (Pallas ``ssd``): per (b, h),
``S_t = e^{a_t} S_{t−1} + B_t x_tᵀ`` and ``y_t = C_tᵀ S_t`` with an f32
N×P state and B, C shared over heads, returning (y, final state).  The
kernels read the shared (Bt, T, N) B and C directly (the TPU wrapper
broadcast them to every head) and take any T.  The input type picks the
kernel: bf16 runs the chunked form on the tensor cores at its own chunk of
64 steps, f32 the sequential recurrence on the CUDA cores; ``chunk`` is
accepted for the reference's signature and changes nothing but rounding
(``tests/test_torch_ssd_chunks.py``; see the note at the top of the
``.cu`` file).

Takes CUDA tensors only; ``ops`` sends CPU tensors to ``ref.ssd_ref``.
``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import _build

_SOURCE = "ssd.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
STATE_DIMS = (4, 8, 16, 32, 64)
MAX_HEAD_DIM = 64

LAUNCHES: Dict[str, int] = {"ssd": 0}


def _lib() -> ctypes.CDLL:
    lib = _build.load(_SOURCE)
    fn = lib.ssd_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def ssd(x: torch.Tensor, a_log: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, s0: torch.Tensor, chunk: int = 64):
    """x: (Bt, H, T, P) f32 or bf16; a_log: (Bt, H, T) f32 ≤ 0; B, C:
    (Bt, T, N) in x's dtype; s0: (Bt, H, N, P).  Returns (y (Bt, H, T, P)
    in x's dtype, final state (Bt, H, N, P) f32).

    x, B and C may have any strides with a contiguous last dimension (bf16:
    16-byte aligned, 8-byte for B and C when N = 4) and a_log any strides,
    so the block's transposed and split activations pass without a copy.
    The output is a (Bt, H, T, P) view of a (Bt, T, H, P) tensor.
    """
    del chunk                       # the kernels pick their own
    for name, t in (("x", x), ("a_log", a_log), ("B", B), ("C", C),
                    ("s0", s0)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"ssd: {name} must be a CUDA tensor on "
                             f"{x.device}, got {t.device}")
    if x.dtype not in _DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise ValueError(f"ssd: x, B, C must share one of {list(_DTYPES)}, "
                         f"got {x.dtype}, {B.dtype}, {C.dtype}")
    if x.dim() != 4:
        raise ValueError(f"ssd: x must be (Bt, H, T, P), got "
                         f"{tuple(x.shape)}")
    Bt, H, T, P = x.shape
    N = B.shape[-1]
    if a_log.shape != (Bt, H, T) or B.shape != (Bt, T, N) \
            or C.shape != B.shape or s0.shape != (Bt, H, N, P):
        raise ValueError(f"ssd: shapes x {tuple(x.shape)}, a_log "
                         f"{tuple(a_log.shape)}, B {tuple(B.shape)}, C "
                         f"{tuple(C.shape)}, s0 {tuple(s0.shape)} do not "
                         "agree")
    for name, t in (("x", x), ("B", B), ("C", C)):
        if t.stride(-1) != 1:
            raise ValueError(f"ssd: {name} needs a contiguous last dim, got "
                             f"strides {t.stride()}")
    if N not in STATE_DIMS or P % 8 or not 8 <= P <= MAX_HEAD_DIM \
            or min(Bt, H, T) < 1:
        raise ValueError(f"ssd: need N in {STATE_DIMS}, P a multiple of 8 "
                         f"up to {MAX_HEAD_DIM}, Bt, H, T ≥ 1; got N={N}, "
                         f"x {tuple(x.shape)}")
    if x.dtype == torch.bfloat16:
        # rows arrive in 16-byte pieces (8-byte for B and C when N = 4)
        for name, t, unit in (("x", x, 16), ("B", B, 16 if N % 8 == 0 else 8),
                              ("C", C, 16 if N % 8 == 0 else 8)):
            step = unit // t.element_size()
            if t.data_ptr() % unit or any(
                    st % step for st, n in zip(t.stride()[:-1],
                                               t.shape[:-1]) if n > 1):
                raise ValueError(f"ssd: {name} needs a {unit}-byte aligned "
                                 f"base and strides, got pointer "
                                 f"{t.data_ptr():#x} strides {t.stride()}")
    a_log = a_log.float()
    s0 = s0.float().contiguous()
    y = torch.empty((Bt, T, H, P), dtype=x.dtype,
                    device=x.device).transpose(1, 2)
    s_out = torch.empty((Bt, H, N, P), dtype=torch.float32, device=x.device)
    st = [*x.stride()[:3], *a_log.stride(), B.stride(0), 0, B.stride(1),
          C.stride(0), 0, C.stride(1), *y.stride()[:3]]
    strides = (ctypes.c_longlong * 15)(*st)
    status = _lib().ssd_launch(
        x.data_ptr(), a_log.data_ptr(), B.data_ptr(), C.data_ptr(),
        s0.data_ptr(), y.data_ptr(), s_out.data_ptr(),
        ctypes.addressof(strides), _DTYPES[x.dtype], Bt, H, T, N, P,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, "ssd_launch")
    _build.count(LAUNCHES, "ssd")
    return y, s_out
