"""Flash attention's backward on the card: wrapper of
``csrc/flash_attention_bwd.cu``, and the autograd ``FlashAttention``.

No TPU kernel answers to it: the reference differentiates its XLA
attention by autodiff.  ``FlashAttention.forward`` launches the flash
forward with its row logsumexp and saves q, k, v, o and lse;
``backward`` launches this kernel, which recomputes P tile by tile
(FlashAttention-2).  Same masks and layouts as the forward; head dims up
to 128.  See the note at the top of the ``.cu`` file for the design.

Takes CUDA tensors only; on the CPU, autograd differentiates
``ref.attention_ref`` and ``ref.attention_bwd_ref`` states the formulas.
``LAUNCHES`` counts calls of the backward (three kernels each).
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as _fa

_SOURCE = "flash_attention_bwd.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 80, 112, 128)
# the head dims whose backward waits (pixtral-12b, nemotron-4-340b)
WAITING_ITEM = "ROADMAP item 13"

LAUNCHES: Dict[str, int] = {"flash_attention_bwd": 0}
_FN = None


def _launch_fn():
    global _FN
    if _FN is None:
        fn = _build.load(_SOURCE).flash_attention_bwd_launch
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 10 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def check_head_dim(D: int) -> None:
    """Raise for a head dim without a backward kernel (160 and 192 wait
    for ``WAITING_ITEM``); never a fallback to the plain version."""
    if D not in HEAD_DIMS:
        raise ValueError(
            f"flash_attention_bwd: head_dim {D} has no backward kernel yet "
            f"(the wide heads of pixtral-12b and nemotron-4-340b wait for "
            f"{WAITING_ITEM}); head dims {HEAD_DIMS}")


def _grad_like(t: torch.Tensor) -> torch.Tensor:
    """An uninitialized (B, heads, S, D) view of a (B, S, heads, D)
    tensor: the layout of the activations the heads came from, so the
    gradient leaves the transposes without a copy."""
    B, Hh, S, D = t.shape
    return torch.empty((B, S, Hh, D), dtype=t.dtype,
                       device=t.device).transpose(1, 2)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, *, causal: bool = True,
                        window: int = 0, prefix: int = 0):
    """(dq, dk, dv) of ``flash_attention(q, k, v)`` at output gradient
    ``do``, given the forward's output ``o`` and row logsumexp ``lse``
    (B, H, Sq) f32.  Each gradient is in its input's dtype, as a (B, heads,
    S, D) view of a (B, S, heads, D) tensor.

    q, k, v, o and do take any strides whose last dimension is contiguous.
    A ``do`` whose last dimension is not contiguous is copied to a
    contiguous tensor first, on every such call.  Head dims 160 and 192
    raise (``WAITING_ITEM``).
    """
    D = q.shape[-1]
    check_head_dim(D)
    if do.dim() == 4 and do.stride(-1) != 1:
        do = do.contiguous()
    dev, dt = q.device, q.dtype
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
        if t.device != dev or not t.is_cuda:
            raise ValueError(f"flash_attention_bwd: {name} must be a CUDA "
                             f"tensor on {dev}, got {t.device}")
        if t.dtype != dt or dt not in _DTYPES:
            raise ValueError(f"flash_attention_bwd: q, k, v, o, do must "
                             f"share one of {list(_DTYPES)}, got {t.dtype}")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"flash_attention_bwd: {name} must be 4-D with "
                             f"a contiguous last dim, got {tuple(t.shape)} "
                             f"strides {t.stride()}")
    B, H, Sq, _ = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if k.shape != (B, Hkv, Sk, D) or v.shape != k.shape \
            or o.shape != q.shape or do.shape != q.shape or Hkv == 0 \
            or H % Hkv or min(B, H, Sq, Sk) < 1:
        raise ValueError(f"flash_attention_bwd: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, o "
                         f"{tuple(o.shape)}, do {tuple(do.shape)} do not "
                         "agree")
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32 \
            or lse.device != dev:
        raise ValueError(f"flash_attention_bwd: lse must be (B, H, Sq) f32 "
                         f"on {dev}, got {tuple(lse.shape)} {lse.dtype}")
    lse = lse.contiguous()
    di = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
    dq, dk, dv = _grad_like(q), _grad_like(k), _grad_like(v)
    strides = (ctypes.c_longlong * 24)(*(s for t in (q, k, v, o, do, dq, dk,
                                                      dv)
                                         for s in t.stride()[:3]))
    status = _launch_fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), di.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), strides, _DTYPES[dt], B, H, Hkv, Sq,
        Sk, D, int(causal), int(window), int(prefix),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "flash_attention_bwd_launch")
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Flash attention with a gradient: the forward kernel (with its row
    logsumexp) and the backward kernel, both hand-written."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, prefix: int):
        check_head_dim(q.shape[-1])   # before the forward, not in backward
        o, lse = _fa.flash_attention(q, k, v, causal=causal, window=window,
                                     prefix=prefix, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = (causal, window, prefix)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, window, prefix = ctx.mask
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                         window=window, prefix=prefix)
        return dq, dk, dv, None, None, None
