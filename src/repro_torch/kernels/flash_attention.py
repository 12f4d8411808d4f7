"""Flash attention on the card: wrapper of ``csrc/flash_attention.cu``.

Port of ``repro/kernels/flash_attention.py`` (Pallas ``flash_attention``)
with its full semantics: causal, ``window`` and ``prefix`` masks, queries
at the tail of the keys, GQA, f32 (m, l, acc), and 0 for rows with no
visible key.  See the note at the top of the ``.cu`` file for the design
and what bounds it.  With ``return_lse`` it also returns each row's
logsumexp, which the backward (``flash_attention_bwd``) reads.

Takes CUDA tensors only; ``ops`` sends CPU tensors to ``ref.attention_ref``.
``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build

_SOURCE = "flash_attention.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 80, 112, 128, 160, 192)
BQ = BKV = 64                   # queries per block, keys per tile
WARP_ROWS = 16                  # queries per warp of the bf16 kernel

LAUNCHES: Dict[str, int] = {"flash_attention": 0}
_FN = None
_LSE_FN = None


def key_tile_range(q_block: int, Sq: int, Sk: int, causal: bool,
                   window: int, prefix: int,
                   rows: int = BQ) -> Tuple[int, int, int]:
    """The key tiles that the ``q_block``-th block of ``rows`` queries
    visits: ``[0, n_pre)`` then ``[lo, hi)``, as ``(n_pre, lo, hi)`` with
    ``n_pre ≤ lo ≤ hi``.

    The block's rows sit at ``q_pos = i + Sk − Sq``.  Causal masking gives
    the upper end (its last row's q_pos), ``window`` the lower end (its
    first row's q_pos − window + 1), and ``prefix`` adds the tiles below
    ``prefix`` back.  Every tile outside ``[0, n_pre) ∪ [lo, hi)`` holds
    no key visible to any of the block's rows.  The bf16 kernel of
    ``csrc/flash_attention.cu`` states the same arithmetic, once for a
    block's ``BQ`` rows and once for each warp's ``WARP_ROWS``.
    """
    qf = q_block * rows + Sk - Sq
    ql = min(Sq, (q_block + 1) * rows) - 1 + Sk - Sq
    k_lo = max(0, qf - window + 1) if window > 0 else 0
    k_hi = min(Sk - 1, ql) if causal else Sk - 1
    p_end = -(-min(prefix, Sk) // BKV) if prefix > 0 else 0
    lo, t_end = (k_lo // BKV, k_hi // BKV + 1) if k_hi >= k_lo else (0, 0)
    return min(p_end, lo), lo, max(t_end, p_end)


def query_tile_range(key_tile: int, Sq: int, Sk: int, causal: bool,
                     window: int, prefix: int,
                     rows: int = BQ) -> Tuple[int, int]:
    """The query tiles of ``rows`` queries that hold a row seeing a key of
    the ``key_tile``-th tile of ``BKV`` keys, as ``[lo, hi)``: the tiles
    the backward's dK/dV block of that key tile walks.

    A tile holding a key below ``prefix`` is seen by every row.  Otherwise
    causal masking gives the first row (the one at the tile's first key,
    ``q_pos = i + Sk − Sq``) and ``window`` the last (the one ``window − 1``
    past the tile's last key).  ``csrc/flash_attention_bwd.cu``
    (``query_tiles``) states the same arithmetic.
    """
    k0 = key_tile * BKV
    kl = min(Sk, k0 + BKV) - 1
    off = Sk - Sq
    if prefix > 0 and k0 < prefix:
        return 0, -(-Sq // rows)
    q_lo = max(0, k0 - off) if causal else 0
    q_hi = min(Sq - 1, kl + window - 1 - off) if window > 0 else Sq - 1
    if q_hi < q_lo:
        return 0, 0
    return q_lo // rows, q_hi // rows + 1


def tile_needs_mask(tile: int, q_block: int, Sq: int, Sk: int,
                    causal: bool, window: int, prefix: int,
                    rows: int = BQ) -> bool:
    """Whether the kernel tests each (query, key) pair of ``tile`` for the
    ``q_block``-th block of ``rows`` queries (the kernel asks it per
    warp): False only when every pair of the tile is visible (a full tile
    inside the prefix, or one that no mask boundary cuts)."""
    k0 = tile * BKV
    if k0 + BKV > Sk:
        return True
    if k0 + BKV <= prefix:
        return False
    qf = q_block * rows + Sk - Sq
    ql = min(Sq, (q_block + 1) * rows) - 1 + Sk - Sq
    return bool((causal and k0 + BKV - 1 > qf)
                or (window > 0 and ql - k0 >= window))


def copyable(t: torch.Tensor) -> bool:
    """Whether the bf16 kernels (this one and the backward) can copy
    ``t``'s rows in 16-byte pieces: the base pointer and every batch, head
    and row stride a multiple of 16 bytes."""
    st = t.stride()
    return t.data_ptr() % 16 == 0 and all(
        st[i] % 8 == 0 for i in range(3) if t.shape[i] > 1)


def _check_aligned(name: str, t: torch.Tensor) -> None:
    """Another layout than ``copyable``'s raises; it is never copied
    quietly."""
    st = t.stride()
    if not copyable(t):
        raise ValueError(f"flash_attention: {name} needs a 16-byte aligned "
                         f"base and strides, got pointer {t.data_ptr():#x} "
                         f"strides {st}")


def _launch_fn():
    global _FN
    if _FN is None:
        fn = _build.load(_SOURCE).flash_attention_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _lse_launch_fn():
    global _LSE_FN
    if _LSE_FN is None:
        fn = _build.load(_SOURCE).flash_attention_lse_launch
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LSE_FN = fn
    return _LSE_FN


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    prefix: int = 0, return_lse: bool = False):
    """q: (B, H, Sq, D); k, v: (B, Hkv, Sk, D) → (B, H, Sq, D) in q.dtype,
    and with ``return_lse`` also the rows' logsumexp of the scaled scores,
    (B, H, Sq) f32, −inf for a row with no visible key.

    Any strides are taken as long as the last dimension is contiguous
    (bf16: and the base and strides are 16-byte aligned), so (B, S, H, D)
    activations pass as ``.transpose(1, 2)`` views without a copy.  The
    result is a (B, H, Sq, D) view of a (B, Sq, H, D) tensor, which
    ``.transpose(1, 2)`` turns back into a contiguous one.
    """
    dev, dt = q.device, q.dtype
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev or not t.is_cuda:
            raise ValueError(f"flash_attention: {name} must be a CUDA tensor "
                             f"on {dev}, got {t.device}")
        if t.dtype != dt or dt not in _DTYPES:
            raise ValueError(f"flash_attention: q, k, v must share one of "
                             f"{list(_DTYPES)}, got {t.dtype}")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name} must be 4-D with a "
                             f"contiguous last dim, got {tuple(t.shape)} "
                             f"strides {t.stride()}")
        if dt == torch.bfloat16:
            _check_aligned(name, t)
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if k.shape != (B, Hkv, Sk, D) or v.shape != k.shape or Hkv == 0 \
            or H % Hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not "
                         "agree (need k == v shape and H % Hkv == 0)")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {D} not in {HEAD_DIMS}")
    if min(B, H, Sq, Sk) < 1:
        raise ValueError(f"flash_attention: empty problem B={B} H={H} "
                         f"Sq={Sq} Sk={Sk}")
    out = torch.empty((B, Sq, H, D), dtype=dt, device=dev).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *out.stride()[:3])
    tail = (_DTYPES[dt], B, H, Hkv, Sq, Sk, D, int(causal), int(window),
            int(prefix), torch.cuda.current_stream(dev).cuda_stream)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    if return_lse:
        lse = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
        status = _lse_launch_fn()(*ptrs, lse.data_ptr(), strides, *tail)
    else:
        status = _launch_fn()(*ptrs, strides, *tail)
    _build.check(status, "flash_attention_launch")
    _build.count(LAUNCHES, "flash_attention")
    return (out, lse) if return_lse else out
