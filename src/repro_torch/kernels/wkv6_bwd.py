"""The RWKV6 recurrence's backward on the card: wrapper of
``csrc/wkv6_bwd.cu``, and the autograd ``WKV6``.

No TPU kernel answers to it: the reference differentiates its XLA
``wkv6_chunked`` by autodiff.  ``WKV6.forward`` launches the ``wkv6``
kernel and saves its inputs; ``backward`` launches this kernel: a reverse
sweep carrying the state's gradient (dk, dv, dS0), a forward sweep carrying
the state (dr, and dlw by a prefix sum), and a sum of du over the batch,
all on the CUDA cores, with every decay factor ≤ 1; the sweeps accumulate
in f32 for bf16 inputs and in f64 for f32 inputs (the prefix sum cancels
where the decay is strong).  See the note at the top of the ``.cu`` file
for the design.

Takes CUDA tensors only; on the CPU, autograd differentiates
``ref.wkv6_ref`` and ``ref.wkv6_bwd_ref`` states the formulas.
``LAUNCHES`` counts calls of the backward (three kernels each).
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import wkv6 as _wkv6
from repro_torch.kernels.flash_attention_bwd import grad_like

_SOURCE = "wkv6_bwd.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the sweeps' accumulation type, and their scratch's (the ``.cu`` header)
ACC_DTYPES = {torch.float32: torch.float64, torch.bfloat16: torch.float32}
HEAD_DIMS = _wkv6.HEAD_DIMS

LAUNCHES: Dict[str, int] = {"wkv6_bwd": 0}
_FN = None


def _launch_fn():
    global _FN
    if _FN is None:
        fn = _build.load(_SOURCE).wkv6_bwd_launch
        fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def wkv6_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             lw: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
             d_out: torch.Tensor, dS_T=None):
    """(dr, dk, dv, dlw, du, dS0) of ``wkv6(r, k, v, lw, u, s0)`` at output
    gradient ``d_out`` (B, H, T, Dh) and final-state gradient ``dS_T``
    (B, H, Dh, Dh), None for zero.  dr, dk, dv in r's dtype and dlw f32,
    each a (B, H, T, Dh) view of a (B, T, H, Dh) tensor; du (H, Dh), summed
    over the batch, and dS0 f32.

    r, k, v, lw and d_out take any strides whose last dimension is
    contiguous (a ``d_out`` that is not is copied first); d_out is in r's
    dtype, lw is read as f32.
    """
    if d_out.dim() == 4 and d_out.stride(-1) != 1:
        d_out = d_out.contiguous()
    dev = r.device
    for name, t in (("r", r), ("k", k), ("v", v), ("lw", lw), ("u", u),
                    ("s0", s0), ("d_out", d_out)) + (
                        (("dS_T", dS_T),) if dS_T is not None else ()):
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"wkv6_bwd: {name} must be a CUDA tensor on "
                             f"{dev}, got {t.device}")
    if r.dtype not in _DTYPES or any(t.dtype != r.dtype
                                     for t in (k, v, d_out)):
        raise ValueError(f"wkv6_bwd: r, k, v, d_out must share one of "
                         f"{list(_DTYPES)}, got {r.dtype}, {k.dtype}, "
                         f"{v.dtype}, {d_out.dtype}")
    if r.dim() != 4:
        raise ValueError(f"wkv6_bwd: r must be (B, H, T, Dh), got "
                         f"{tuple(r.shape)}")
    B, H, T, Dh = r.shape
    for name, t in (("r", r), ("k", k), ("v", v), ("lw", lw),
                    ("d_out", d_out)):
        if t.shape != r.shape or t.stride(-1) != 1:
            raise ValueError(f"wkv6_bwd: {name} must match r "
                             f"{tuple(r.shape)} with a contiguous last dim, "
                             f"got {tuple(t.shape)} strides {t.stride()}")
    if Dh not in HEAD_DIMS or min(B, H, T) < 1:
        raise ValueError(f"wkv6_bwd: need Dh in {HEAD_DIMS} and B, H, T ≥ 1,"
                         f" got {tuple(r.shape)}")
    if u.shape != (H, Dh) or s0.shape != (B, H, Dh, Dh) or (
            dS_T is not None and dS_T.shape != s0.shape):
        raise ValueError(f"wkv6_bwd: u {tuple(u.shape)} / s0 "
                         f"{tuple(s0.shape)} / dS_T do not match r "
                         f"{tuple(r.shape)}")
    lw = lw.float()
    u = u.float().contiguous()
    s0 = s0.float().contiguous()
    if dS_T is not None:
        dS_T = dS_T.float().contiguous()
    dr, dk, dv = grad_like(r), grad_like(k), grad_like(v)
    dlw = grad_like(lw, torch.float32)
    du = torch.empty((H, Dh), dtype=torch.float32, device=dev)
    ds0 = torch.empty((B, H, Dh, Dh), dtype=torch.float32, device=dev)
    du_part = torch.empty((B, H, Dh), dtype=torch.float32, device=dev)
    acc = dict(dtype=ACC_DTYPES[r.dtype], device=dev)
    kdk = torch.empty((B, H, T, Dh), **acc)     # k ⊙ dk̃, launch 1 → 2
    c0 = torch.empty((B, H, Dh), **acc)         # each row's ⟨s0, dS0⟩
    strides = (ctypes.c_longlong * 27)(
        *(s for t in (r, k, v, lw, d_out, dr, dk, dv, dlw)
          for s in t.stride()[:3]))
    status = _launch_fn()(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
        u.data_ptr(), s0.data_ptr(), d_out.data_ptr(),
        dS_T.data_ptr() if dS_T is not None else None, dr.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), dlw.data_ptr(), du.data_ptr(),
        ds0.data_ptr(), du_part.data_ptr(), kdk.data_ptr(), c0.data_ptr(),
        ctypes.addressof(strides),
        _DTYPES[r.dtype], B, H, T, Dh,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "wkv6_bwd_launch")
    LAUNCHES["wkv6_bwd"] += 1
    return dr, dk, dv, dlw, du, ds0


class WKV6(torch.autograd.Function):
    """The WKV6 recurrence with a gradient: the ``wkv6`` kernel forward and
    this backward kernel, both hand-written.  Returns (out, final state);
    autograd hands the backward zeros for an output that took no
    gradient."""

    @staticmethod
    def forward(ctx, r, k, v, lw, u, s0, chunk: int):
        out, S = _wkv6.wkv6(r, k, v, lw, u, s0, chunk=chunk)
        ctx.save_for_backward(r, k, v, lw, u, s0)
        return out, S

    @staticmethod
    def backward(ctx, d_out, dS_T):
        return (*wkv6_bwd(*ctx.saved_tensors, d_out, dS_T), None)
