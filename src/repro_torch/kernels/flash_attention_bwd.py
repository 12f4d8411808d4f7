"""Flash attention's backward on the card: wrapper of
``csrc/flash_attention_bwd.cu``, and the autograd ``FlashAttention``.

No TPU kernel answers to it: the reference differentiates its XLA
attention by autodiff.  ``FlashAttention.forward`` launches the flash
forward with its row logsumexp and saves q, k, v, o and lse;
``backward`` launches this kernel, which recomputes P tile by tile
(FlashAttention-2): bf16 on the tensor cores, f32 on the CUDA cores.
Same masks, layouts and head dims as the forward.  See the note at the
top of the ``.cu`` file for the design; ``piece_visibility`` states the
rule by which its warps skip pieces of a tile or test their pairs.

Takes CUDA tensors only; on the CPU, autograd differentiates
``ref.attention_ref`` and ``ref.attention_bwd_ref`` states the formulas.
``LAUNCHES`` counts calls of the backward (three kernels each).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as _fa

_SOURCE = "flash_attention_bwd.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = _fa.HEAD_DIMS

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


def piece_visibility(qa: int, qb: int, ka: int, kb: int, Sq: int, Sk: int,
                     causal: bool, window: int,
                     prefix: int) -> Tuple[bool, bool]:
    """(some pair visible, every pair visible) for query rows ``qa`` …
    ``qb`` and keys ``ka`` … ``kb``, in the mask of ``ref.attention_mask``
    (rows past Sq and keys past Sk see nothing): the rule by which a warp
    of the bf16 kernels skips a piece of its tile or tests its pairs
    (``some_visible`` / ``all_visible`` in ``csrc/flash_attention_bwd.cu``).

    Keys below ``prefix`` are seen by every row; otherwise a pair is seen
    when ``rel = q_pos − k`` (``q_pos = i + Sk − Sq``) is ≥ 0 if causal
    and < ``window`` if ``window > 0``, and over the piece ``rel`` spans
    ``[qa + off − kb, qb + off − ka]``.
    """
    off = Sk - Sq
    some = False
    qc, kc = min(qb, Sq - 1), min(kb, Sk - 1)
    if qa <= qc and ka <= kc:
        some = ka < prefix or not (
            (causal and qc + off - ka < 0)
            or (window > 0 and qa + off - kc >= window))
    every = qb < Sq and kb < Sk and (kb < prefix or not (
        (causal and qa + off - kb < 0)
        or (window > 0 and qb + off - max(ka, prefix) >= window)))
    return some, every


def grad_like(t: torch.Tensor, dtype=None) -> torch.Tensor:
    """An uninitialized (B, heads, S, D) view of a (B, S, heads, D)
    tensor, in ``t``'s dtype unless ``dtype`` is given: the layout of the
    activations the heads came from, so the gradient leaves the
    transposes without a copy."""
    B, Hh, S, D = t.shape
    return torch.empty((B, S, Hh, D), dtype=dtype or t.dtype,
                       device=t.device).transpose(1, 2)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, *, causal: bool = True,
                        window: int = 0, prefix: int = 0):
    """(dq, dk, dv) of ``flash_attention(q, k, v)`` at output gradient
    ``do``, given the forward's output ``o`` and row logsumexp ``lse``
    (B, H, Sq) f32.  Each gradient is in its input's dtype, as a (B, heads,
    S, D) view of a (B, S, heads, D) tensor.

    q, k, v, o and do take any strides whose last dimension is contiguous
    (bf16: with 16-byte aligned bases and strides; q, k, v and o that are
    not raise).  A ``do`` that the kernel cannot read as it is (autograd
    makes it, not the caller) is copied to a contiguous tensor first, on
    every such call.
    """
    D = q.shape[-1]
    if do.dim() == 4 and (do.stride(-1) != 1 or (
            do.dtype == torch.bfloat16 and not _fa.copyable(do))):
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
        if dt == torch.bfloat16 and not _fa.copyable(t):
            raise ValueError(f"flash_attention_bwd: {name} needs a 16-byte "
                             f"aligned base and strides, got pointer "
                             f"{t.data_ptr():#x} strides {t.stride()}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: head_dim {D} not in "
                         f"{HEAD_DIMS}")
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
    dq, dk, dv = grad_like(q), grad_like(k), grad_like(v)
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
    _build.count(LAUNCHES, "flash_attention_bwd")
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Flash attention with a gradient: the forward kernel (with its row
    logsumexp) and the backward kernel, both hand-written."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, prefix: int):
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
