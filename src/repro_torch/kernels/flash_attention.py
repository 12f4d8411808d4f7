"""Flash attention on the card: wrapper of ``csrc/flash_attention.cu``.

Port of ``repro/kernels/flash_attention.py`` (Pallas ``flash_attention``)
with its full semantics: causal, ``window`` and ``prefix`` masks, queries
at the tail of the keys, GQA, f32 (m, l, acc), and 0 for rows with no
visible key.  See the note at the top of the ``.cu`` file for the design
and what bounds it.

Takes CUDA tensors only; ``ops`` sends CPU tensors to ``ref.attention_ref``.
``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import _build

_SOURCE = "flash_attention.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 80, 112, 128)
_MAX_GRID_Y = 65535

LAUNCHES: Dict[str, int] = {"flash_attention": 0}


def _lib() -> ctypes.CDLL:
    lib = _build.load(_SOURCE)
    fn = lib.flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    prefix: int = 0) -> torch.Tensor:
    """q: (B, H, Sq, D); k, v: (B, Hkv, Sk, D) → (B, H, Sq, D) in q.dtype.

    Any strides are taken as long as the last dimension is contiguous, so
    (B, S, H, D) activations pass as ``.transpose(1, 2)`` views without a
    copy.  The result is a (B, H, Sq, D) view of a (B, Sq, H, D) tensor,
    which ``.transpose(1, 2)`` turns back into a contiguous one.
    """
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"flash_attention: {name} must be a CUDA tensor "
                             f"on {q.device}, got {t.device}")
        if t.dtype != q.dtype or t.dtype not in _DTYPES:
            raise ValueError(f"flash_attention: q, k, v must share one of "
                             f"{list(_DTYPES)}, got {t.dtype}")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name} must be 4-D with a "
                             f"contiguous last dim, got {tuple(t.shape)} "
                             f"strides {t.stride()}")
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if k.shape != (B, Hkv, Sk, D) or v.shape != k.shape or Hkv == 0 \
            or H % Hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not "
                         "agree (need k == v shape and H % Hkv == 0)")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {D} not in {HEAD_DIMS}")
    if min(B, H, Sq, Sk) < 1 or -(-Sq // 64) > _MAX_GRID_Y:
        raise ValueError(f"flash_attention: empty or oversized problem "
                         f"B={B} H={H} Sq={Sq} Sk={Sk}")
    out = torch.empty((B, Sq, H, D), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    status = _lib().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        ctypes.addressof(strides), _DTYPES[q.dtype], B, H, Hkv, Sq, Sk, D,
        int(causal), int(window), int(prefix),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, "flash_attention_launch")
    LAUNCHES["flash_attention"] += 1
    return out
