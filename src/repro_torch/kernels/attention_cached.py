"""Cached attention on the card: wrapper of ``csrc/attention_cached.cu``.

Attention over a dense or ring KV cache with per-row positions: the
decode step and the ring-buffer prefill chunk of
``models.layers.attention``.  No TPU kernel stands behind it; it computes
exactly ``ref.attention_positions_ref`` (the reference's XLA
``_sdpa_chunked`` with ``kv_positions`` / ``kv_valid``), except that a row
with no visible key gives 0.  See the note at the top of the ``.cu`` file
for the design and what bounds it.

Takes CUDA tensors only; ``ops`` sends CPU tensors to the plain version.
``LAUNCHES`` counts wrapper calls that launched the kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build

_SOURCE = "attention_cached.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 80, 112, 128, 160, 192)
ROWS = 16                  # query rows per block
BK = 64                    # key slots per tile
BLOCKS_PER_SM = 2          # the grid a split plan aims for, per SM

LAUNCHES: Dict[str, int] = {"attention_cached": 0}
_FN = None


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_plan(B: int, H: int, Hkv: int, Sq: int, Sk: int, n_sm: int
               ) -> Tuple[int, int]:
    """``(keys_per_split, n_split)``: the key range of one block and the
    number of ranges.  Splits are added until the grid holds about
    ``BLOCKS_PER_SM`` blocks on each of the card's ``n_sm`` SMs (a decode
    step has only B·Hkv row tiles); each range is a whole number of key
    tiles.  n_split == 1 writes the output straight from the block."""
    tiles = -(-Sk // BK)
    blocks = B * Hkv * -(-(H // Hkv) * Sq // ROWS)
    want = max(1, min(tiles, -(-BLOCKS_PER_SM * n_sm // blocks)))
    per = -(-tiles // want)
    return per * BK, -(-tiles // per)


def _check_aligned(name: str, t: torch.Tensor) -> None:
    """K and V are read in 16-byte pieces: the base pointer and every
    batch, head and row stride must be a multiple of 16 bytes."""
    st, per = t.stride(), 16 // t.element_size()
    if t.data_ptr() % 16 or any(st[i] % per for i in range(3)
                                if t.shape[i] > 1):
        raise ValueError(f"attention_cached: {name} needs a 16-byte aligned "
                         f"base and strides, got pointer {t.data_ptr():#x} "
                         f"strides {st}")


def _launch_fn():
    global _FN
    if _FN is None:
        fn = _build.load(_SOURCE).attention_cached_launch
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 11 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def attention_cached(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                     causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, H, Sq, D); k, v: (B, Hkv, Sk, D); q_pos: (B, Sq), kv_pos:
    (B, Sk) integer positions (< 0: empty slot) → (B, H, Sq, D) in q.dtype.

    Any strides are taken as long as the last dimension is contiguous
    (K and V: 16-byte aligned), so a (B, S, Hkv, D) cache passes as a
    ``.transpose(1, 2)`` view.  The result is a (B, H, Sq, D) view of a
    (B, Sq, H, D) tensor.
    """
    dev, dt = q.device, q.dtype
    for name, t in (("q", q), ("k", k), ("v", v), ("q_pos", q_pos),
                    ("kv_pos", kv_pos)):
        if t.device != dev or not t.is_cuda:
            raise ValueError(f"attention_cached: {name} must be a CUDA "
                             f"tensor on {dev}, got {t.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != dt or dt not in _DTYPES:
            raise ValueError(f"attention_cached: q, k, v must share one of "
                             f"{list(_DTYPES)}, got {t.dtype}")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"attention_cached: {name} must be 4-D with a "
                             f"contiguous last dim, got {tuple(t.shape)} "
                             f"strides {t.stride()}")
    _check_aligned("k", k)
    _check_aligned("v", v)
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if k.shape != (B, Hkv, Sk, D) or v.shape != k.shape or Hkv == 0 \
            or H % Hkv:
        raise ValueError(f"attention_cached: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not "
                         "agree (need k == v shape and H % Hkv == 0)")
    if q_pos.shape != (B, Sq) or kv_pos.shape != (B, Sk):
        raise ValueError(f"attention_cached: q_pos {tuple(q_pos.shape)} "
                         f"and kv_pos {tuple(kv_pos.shape)} must be "
                         f"({B}, {Sq}) and ({B}, {Sk})")
    if q_pos.dtype.is_floating_point or kv_pos.dtype.is_floating_point:
        raise ValueError("attention_cached: positions must be integers")
    if D not in HEAD_DIMS:
        raise ValueError(f"attention_cached: head_dim {D} not in "
                         f"{HEAD_DIMS}")
    if min(B, H, Sq, Sk) < 1:
        raise ValueError(f"attention_cached: empty problem B={B} H={H} "
                         f"Sq={Sq} Sk={Sk}")
    q_pos = q_pos.to(torch.int32).contiguous()
    kv_pos = kv_pos.to(torch.int32).contiguous()
    per, n_split = split_plan(B, H, Hkv, Sq, Sk, _sm_count(
        dev.index if dev.index is not None else torch.cuda.current_device()))
    out = torch.empty((B, Sq, H, D), dtype=dt, device=dev).transpose(1, 2)
    if n_split > 1:
        part_acc = torch.empty((n_split, B * H * Sq, D), dtype=torch.float32,
                               device=dev)
        part_ml = torch.empty((n_split, B * H * Sq, 2), dtype=torch.float32,
                              device=dev)
        ptrs = (part_acc.data_ptr(), part_ml.data_ptr())
    else:
        ptrs = (None, None)
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *out.stride()[:3])
    status = _launch_fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
        kv_pos.data_ptr(), out.data_ptr(), *ptrs, strides, _DTYPES[dt], B,
        H, Hkv, Sq, Sk, D, int(causal), int(window), per, n_split,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "attention_cached_launch")
    LAUNCHES["attention_cached"] += 1
    return out
