"""The RWKV6 recurrence's backward on the card: wrapper of
``csrc/wkv6_bwd.cu``, and the autograd ``WKV6``.

No TPU kernel answers to it: the reference differentiates its XLA
``wkv6_chunked`` by autodiff.  ``WKV6.forward`` launches the ``wkv6``
kernel and saves its inputs; ``backward`` launches this kernel.  bf16
inputs take the chunked form on the tensor cores, chunks of 64 steps in
parallel: each chunk's own state contributions, a scan over the chunks for
the boundary states, then every chunk's gradients, dlw by a prefix sum
re-anchored at each chunk, and du summed over the batch and the chunks
(four launches).  f32 inputs take two step sweeps on the CUDA cores
accumulating in f64 (three launches).  See the note at the top of the
``.cu`` file for the designs.

Takes CUDA tensors only; on the CPU, autograd differentiates
``ref.wkv6_ref`` and ``ref.wkv6_bwd_ref`` states the formulas.
``LAUNCHES`` counts calls of the backward.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import wkv6 as _wkv6
from repro_torch.kernels.flash_attention_bwd import grad_like

_SOURCE = "wkv6_bwd.cu"
_DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = _wkv6.HEAD_DIMS
CHUNK = 64          # the bf16 route's chunk (``L`` in the ``.cu`` file)

LAUNCHES: Dict[str, int] = {"wkv6_bwd": 0}


def _fn(name: str, n_ptr: int):
    fn = getattr(_build.load(_SOURCE), name)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def aligned(t: torch.Tensor) -> bool:
    """Whether ``t``'s rows arrive in 16-byte pieces: the base pointer and
    every stride but the last a multiple of 16 bytes."""
    step = 16 // t.element_size()
    return t.data_ptr() % 16 == 0 and not any(
        st % step for st, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1)


def wkv6_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             lw: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
             d_out: torch.Tensor, dS_T=None):
    """(dr, dk, dv, dlw, du, dS0) of ``wkv6(r, k, v, lw, u, s0)`` at output
    gradient ``d_out`` (B, H, T, Dh) and final-state gradient ``dS_T``
    (B, H, Dh, Dh), None for zero.  dr, dk, dv in r's dtype and dlw f32,
    each a (B, H, T, Dh) view of a (B, T, H, Dh) tensor; du (H, Dh), summed
    over the batch, and dS0 f32.

    r, k, v, lw and d_out take any strides whose last dimension is
    contiguous (a ``d_out`` that is not is copied first; bf16: 16-byte
    aligned rows of r, k, v and lw, and a ``d_out`` without them is
    copied); d_out is in r's dtype, lw is read as f32.
    """
    if d_out.dim() == 4 and (d_out.stride(-1) != 1 or (
            d_out.dtype == torch.bfloat16 and not aligned(d_out))):
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
                         f"{_DTYPES}, got {r.dtype}, {k.dtype}, "
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
    bf16 = r.dtype == torch.bfloat16
    if bf16:
        for name, t in (("r", r), ("k", k), ("v", v), ("lw", lw)):
            if not aligned(t):
                raise ValueError(f"wkv6_bwd: {name} needs a 16-byte aligned "
                                 f"base and strides, got pointer "
                                 f"{t.data_ptr():#x} strides {t.stride()}")
    u = u.float().contiguous()
    s0 = s0.float().contiguous()
    if dS_T is not None:
        dS_T = dS_T.float().contiguous()
    f32 = dict(dtype=torch.float32, device=dev)
    dr, dk, dv = grad_like(r), grad_like(k), grad_like(v)
    dlw = grad_like(lw, torch.float32)
    du = torch.empty((H, Dh), **f32)
    ds0 = torch.empty((B, H, Dh, Dh), **f32)
    strides = (ctypes.c_longlong * 27)(
        *(s for t in (r, k, v, lw, d_out, dr, dk, dv, dlw)
          for s in t.stride()[:3]))
    ptrs = [r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
            u.data_ptr(), s0.data_ptr(), d_out.data_ptr(),
            dS_T.data_ptr() if dS_T is not None else None, dr.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), dlw.data_ptr(), du.data_ptr(),
            ds0.data_ptr()]
    if bf16:
        nc = -(-T // CHUNK)
        # each chunk's dS then S0, its dG then Ge; cw of its last step;
        # dlw at its first step; its share of du
        scratch = [torch.empty((B, H, nc, 64, 64), **f32),
                   torch.empty((B, H, nc, 64, 64), **f32),
                   torch.empty((B, H, nc, 64), **f32),
                   torch.empty((B, H, nc, 64), **f32),
                   torch.empty((B, nc, H, Dh), **f32)]
        name = "wkv6_bwd_chunked_launch"
    else:
        scratch = [torch.empty((B, H, Dh), **f32),           # du's shares
                   torch.empty((B, H, T, Dh), dtype=torch.float64,
                               device=dev),                  # k ⊙ dk̃
                   torch.empty((B, H, Dh), dtype=torch.float64,
                               device=dev)]                  # ⟨s0, dS0⟩
        name = "wkv6_bwd_launch"
    ptrs += [t.data_ptr() for t in scratch]
    status = _fn(name, len(ptrs) + 1)(
        *ptrs, ctypes.addressof(strides), B, H, T, Dh,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, name)
    _build.count(LAUNCHES, "wkv6_bwd")
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
