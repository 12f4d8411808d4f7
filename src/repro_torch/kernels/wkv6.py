"""RWKV6 recurrence on the card: wrapper of ``csrc/wkv6.cu``.

Port of ``repro/kernels/wkv6.py`` (Pallas ``wkv6``): per (b, h),
``out_t = r_tᵀ(S_{t−1} + diag(u) k_t v_tᵀ)`` and
``S_t = diag(e^{lw_t}) S_{t−1} + k_t v_tᵀ`` with an f32 Dh×Dh state,
returning (out, final state).  bf16 inputs run the chunked form on the
tensor cores at the kernel's own chunk of 64 steps, f32 inputs the step
recurrence on the CUDA cores; both take any T, and ``chunk`` is accepted
for the reference's signature and changes nothing but rounding (see the
note at the top of the ``.cu`` file for the designs and what bounds
them).

Takes CUDA tensors only; ``ops`` sends CPU tensors to ``ref.wkv6_ref``.
``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import _build

_SOURCE = "wkv6.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (8, 16, 32, 64)

LAUNCHES: Dict[str, int] = {"wkv6": 0}


def _lib() -> ctypes.CDLL:
    lib = _build.load(_SOURCE)
    fn = lib.wkv6_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         lw: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
         chunk: int = 16):
    """r, k, v: (B, H, T, Dh) f32 or bf16; lw: (B, H, T, Dh) f32 ≤ 0;
    u: (H, Dh); s0: (B, H, Dh, Dh).  Returns (out (B, H, T, Dh) in r's
    dtype, final state (B, H, Dh, Dh) f32).

    r, k, v and lw may have any strides with a contiguous last dimension
    (bf16: 16-byte aligned rows of r, k, v and lw), so (B, T, H, Dh)
    activations pass as ``.transpose(1, 2)`` views.  The output is a
    (B, H, T, Dh) view of a (B, T, H, Dh) tensor.
    """
    del chunk                       # the kernels pick their own
    for name, t in (("r", r), ("k", k), ("v", v), ("lw", lw), ("u", u),
                    ("s0", s0)):
        if not t.is_cuda or t.device != r.device:
            raise ValueError(f"wkv6: {name} must be a CUDA tensor on "
                             f"{r.device}, got {t.device}")
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError(f"wkv6: r, k, v must share one of {list(_DTYPES)}, "
                         f"got {r.dtype}, {k.dtype}, {v.dtype}")
    if r.dim() != 4:
        raise ValueError(f"wkv6: r must be (B, H, T, Dh), got "
                         f"{tuple(r.shape)}")
    B, H, T, Dh = r.shape
    for name, t in (("k", k), ("v", v), ("lw", lw)):
        if t.shape != r.shape or t.stride(-1) != 1:
            raise ValueError(f"wkv6: {name} must match r {tuple(r.shape)} "
                             f"with a contiguous last dim, got "
                             f"{tuple(t.shape)} strides {t.stride()}")
    if r.stride(-1) != 1:
        raise ValueError(f"wkv6: r needs a contiguous last dim, got strides "
                         f"{r.stride()}")
    if Dh not in HEAD_DIMS or min(B, H, T) < 1:
        raise ValueError(f"wkv6: need Dh in {HEAD_DIMS} and B, H, T ≥ 1, "
                         f"got {tuple(r.shape)}")
    if u.shape != (H, Dh) or s0.shape != (B, H, Dh, Dh):
        raise ValueError(f"wkv6: u {tuple(u.shape)} / s0 {tuple(s0.shape)} "
                         f"do not match r {tuple(r.shape)}")
    lw = lw.float()
    if r.dtype == torch.bfloat16:
        # rows arrive in 16-byte pieces
        for name, t in (("r", r), ("k", k), ("v", v), ("lw", lw)):
            step = 16 // t.element_size()
            if t.data_ptr() % 16 or any(
                    st % step for st, n in zip(t.stride()[:-1],
                                               t.shape[:-1]) if n > 1):
                raise ValueError(f"wkv6: {name} needs a 16-byte aligned "
                                 f"base and strides, got pointer "
                                 f"{t.data_ptr():#x} strides {t.stride()}")
    u = u.float().contiguous()
    s0 = s0.float().contiguous()
    out = torch.empty((B, T, H, Dh), dtype=r.dtype,
                      device=r.device).transpose(1, 2)
    s_out = torch.empty((B, H, Dh, Dh), dtype=torch.float32, device=r.device)
    strides = (ctypes.c_longlong * 15)(
        *(s for t in (r, k, v, lw, out) for s in t.stride()[:3]))
    status = _lib().wkv6_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
        u.data_ptr(), s0.data_ptr(), out.data_ptr(), s_out.data_ptr(),
        ctypes.addressof(strides), _DTYPES[r.dtype], B, H, T, Dh,
        torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(status, "wkv6_launch")
    _build.count(LAUNCHES, "wkv6")
    return out, s_out
