"""Cached attention on the card: wrapper of ``csrc/attention_cached.cu``.

Attention over a dense or ring KV cache with per-row positions: the
decode step and the ring-buffer prefill chunk of
``models.layers.attention``.  No TPU kernel stands behind it; it computes
exactly ``ref.attention_positions_ref`` (the reference's XLA
``_sdpa_chunked`` with ``kv_positions`` / ``kv_valid``), except that a row
with no visible key gives 0.  See the note at the top of the ``.cu`` file
for the design and what bounds it.

``block_rows``, ``split_plan`` and ``tile_class`` state the bf16 kernel's
arithmetic in Python (its rows per block, its key ranges, and which key
tiles it skips or copies without a mask test), so the CPU tests can hold
them against ``ref.positions_mask``.

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
ROWS = 64                  # query rows of a bf16 block at most (four warps)
WARP_ROWS = 16             # query rows of a row group (one mma's M)
BK = 64                    # key slots per tile
BLOCKS_PER_SM = 1          # the grid a split plan aims for, per SM
MIN_TILES = 5              # key tiles at least, for the keys to split

LAUNCHES: Dict[str, int] = {"attention_cached": 0}
_FN = None


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def block_rows(R: int) -> int:
    """Query rows of a bf16 block when a kv head's group has R = G·Sq
    rows: 16 (its four warps then split each key tile four ways), 32 (two
    row groups, two ways) or ``ROWS`` (a row group a warp)."""
    return 16 if R <= 16 else 32 if R <= 32 else ROWS


def split_plan(B: int, H: int, Hkv: int, Sq: int, Sk: int, n_sm: int
               ) -> Tuple[int, int]:
    """``(keys_per_split, n_split)``: the key range of one block and the
    number of ranges, each a whole number of key tiles.  Keys of fewer
    than ``MIN_TILES`` tiles do not split: a block walks its tiles one
    after another (~0.6 µs a tile at decode), and splits cost a second
    launch that merges them (~3 µs).  Longer keys split until the grid
    holds about ``BLOCKS_PER_SM`` bf16 blocks on each of the card's
    ``n_sm`` SMs (a decode step has only B·Hkv row blocks).  Both numbers
    come from ``compare.py --sweep-cached``, which times every split at
    the check shapes (PERF.md §6, PR 19).  n_split == 1 writes the output
    straight from the block.  The f32 kernel takes the same ranges."""
    R = H // Hkv * Sq
    tiles = -(-Sk // BK)
    if tiles < MIN_TILES:
        return tiles * BK, 1
    blocks = B * Hkv * -(-R // block_rows(R))
    per = -(-tiles // min(tiles, -(-BLOCKS_PER_SM * n_sm // blocks)))
    return per * BK, -(-tiles // per)


def tile_class(kv_tile: torch.Tensor, q_lo: int, q_hi: int, causal: bool,
               window: int) -> str:
    """``"skip"``, ``"full"`` or ``"masked"``: how the bf16 kernel treats a
    tile of ``BK`` key slots (positions, < 0 for an empty slot or one past
    the keys) for rows whose positions span ``[q_lo, q_hi]``.

    From the count of valid slots and the min and max of their positions
    alone (a wrapped ring's slots are in no order): skip when no valid
    slot can be visible to any such row, full when every slot is valid
    and visible to every row (no mask test), masked otherwise.  A block
    copies the tiles that are not skipped for all of its rows; each warp
    classifies them again for its own 16.
    """
    valid = kv_tile[kv_tile >= 0]
    if q_lo > q_hi or valid.numel() == 0:
        return "skip"
    k_min, k_max = int(valid.min()), int(valid.max())
    if (causal and k_min > q_hi) or (window > 0 and q_lo - k_max >= window):
        return "skip"
    if valid.numel() == BK and (not causal or k_max <= q_lo) \
            and (window <= 0 or q_hi - k_min < window):
        return "full"
    return "masked"


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
    ptrs = (None, None)
    if n_split > 1:
        part_acc = torch.empty((n_split, B * H * Sq, D), dtype=torch.float32,
                               device=dev)
        part_ml = torch.empty((n_split, B * H * Sq, 2), dtype=torch.float32,
                              device=dev)
        ptrs = (part_acc.data_ptr(), part_ml.data_ptr())
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *out.stride()[:3])
    status = _launch_fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
        kv_pos.data_ptr(), out.data_ptr(), *ptrs, strides, _DTYPES[dt], B,
        H, Hkv, Sq, Sk, D, int(causal), int(window), per, n_split,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "attention_cached_launch")
    _build.count(LAUNCHES, "attention_cached")
    return out
