"""The bf16 cached-attention kernel's tile rule against the plain mask.

``attention_cached.tile_class`` says how ``csrc/attention_cached.cu``
treats a tile of ``BK`` key slots for a set of query rows: skipped (never
copied, when no row of the block can see it; not multiplied, when no row
of a warp's 16 can), full (multiplied without a mask test) or masked (each
pair tested).  It reads only the tile's count of valid slots and the min
and max of their positions, so it must hold for slots in any order (a
wrapped ring).  Over the check shapes of ``checks.CACHED_CASES`` and
seeded random positions (ragged caches, wrapped rings, ring chunks with
empty old slots, windows, slots in no order), against
``ref.positions_mask``: a skipped tile holds no visible pair, a full tile
only visible pairs, and so every visible pair lies in a tile that is not
skipped.  Exact: these are integer rules.  The rows follow the kernel's
mapping: row r of a kv head's group is query r % Sq, ``block_rows``
rows a block, 16 rows a warp's row group.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import checks, ref
from repro_torch.kernels.attention_cached import (BK, ROWS, WARP_ROWS,
                                                  block_rows, tile_class)


def _check(q_pos, kv_pos, G, causal, window):
    """Classify every tile for every block and row group of each batch row
    and hold the classes against the mask; returns (tiles copied, tiles
    in all) over the blocks."""
    B, Sq = q_pos.shape
    Sk = kv_pos.shape[1]
    n_tiles = -(-Sk // BK)
    pad = torch.full((B, n_tiles * BK - Sk), -1, dtype=kv_pos.dtype)
    slots = torch.cat([kv_pos, pad], 1)
    mask = ref.positions_mask(q_pos, kv_pos, causal=causal, window=window)
    mask = torch.cat([mask, torch.zeros(B, Sq, pad.shape[1],
                                         dtype=torch.bool)], 2)
    R = G * Sq
    rb = block_rows(R)
    query = torch.arange(R) % Sq              # row r of the group
    copied = total = 0
    for b in range(B):
        for r0 in range(0, R, rb):
            rows = query[r0:min(R, r0 + rb)]
            qb = q_pos[b, rows]
            for t in range(n_tiles):
                tile = slots[b, t * BK:(t + 1) * BK]
                seen = mask[b, rows, t * BK:(t + 1) * BK]
                total += 1
                block = tile_class(tile, int(qb.min()), int(qb.max()),
                                   causal, window)
                if block == "skip":
                    assert not seen.any(), (b, r0, t)
                    continue
                copied += 1
                for w0 in range(0, len(rows), WARP_ROWS):
                    qw = qb[w0:w0 + WARP_ROWS]
                    vis = seen[w0:w0 + WARP_ROWS]
                    cls = tile_class(tile, int(qw.min()), int(qw.max()),
                                     causal, window)
                    case = (b, r0 + w0, t, cls)
                    if cls == "skip":
                        assert not vis.any(), case
                    elif cls == "full":
                        assert vis.all() and bool((tile >= 0).all()), case
    return copied, total


def _case_positions(tag):
    B, H, Hkv, Sq, Sk, D, window, kind = checks.CACHED_CASES[tag]
    g = torch.Generator()
    g.manual_seed(0)
    _, _, _, q_pos, kv_pos = checks.cached_inputs(g, "cpu", B, 1, 1, Sq, Sk,
                                                  8, window, kind)
    return q_pos, kv_pos, H // Hkv, window


@pytest.mark.parametrize("tag", sorted(checks.CACHED_CASES))
def test_check_case_tiles_hold_against_the_mask(tag):
    q_pos, kv_pos, G, window = _case_positions(tag)
    _check(q_pos, kv_pos, G, True, window)


def test_a_ragged_cache_copies_only_its_filled_tiles():
    """granite-3-2b's decode: lengths 1 … 1024 over 8 rows fill 68 of
    their 128 tiles; the blocks copy those and skip the empty tail."""
    q_pos, kv_pos, G, window = _case_positions("granite_decode")
    assert _check(q_pos, kv_pos, G, True, window) == (68, 128)


def _random_positions(rng, kind, B, Sq, Sk):
    """(q_pos (B, Sq), kv_pos (B, S_keys), window) int32 of one kind."""
    j = np.arange(Sk)[None]
    if kind == "ragged":            # a dense cache, each row its length
        length = rng.integers(0, Sk + 1, (B, 1))
        kv = np.where(j < length, j, -1)
        q = np.maximum(length - 1, 0) + np.arange(Sq)[None] - (Sq - 1)
        window = 0
    elif kind == "ragged_window":
        length = rng.integers(1, Sk + 1, (B, 1))
        kv = np.where(j < length, j, -1)
        q = length - 1 + np.zeros((1, Sq), int)
        window = int(rng.integers(1, Sk))
    elif kind == "ring":            # wrapped: latest - (latest - j) % W
        latest = rng.integers(Sk, 4 * Sk, (B, 1))
        kv = latest - np.remainder(latest - j, Sk)
        q = latest + np.zeros((1, Sq), int)
        window = Sk
    elif kind == "chunk":           # [old ring ∪ chunk], some old slots empty
        p0 = rng.integers(0, 2 * Sk, (B, 1))
        old = p0 - 1 - np.remainder(p0 - 1 - j, Sk)
        q = p0 + np.arange(Sq)[None]
        kv = np.concatenate([np.where(old >= 0, old, -1), q], 1)
        window = Sk
    elif kind == "shuffled":        # slots in no order, holes, any queries
        kv = rng.integers(-40, 300, (B, Sk))
        kv = np.where(kv < 0, -1, kv)
        q = rng.integers(0, 320, (B, Sq))
        window = int(rng.integers(0, 200))
    else:
        raise ValueError(kind)
    return (torch.from_numpy(q.astype(np.int32)),
            torch.from_numpy(kv.astype(np.int32)), window)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("kind,B,Sq,Sk,G", [
    ("ragged", 6, 1, 700, 4),
    ("ragged", 3, 5, 300, 4),
    ("ragged_window", 5, 1, 500, 12),
    ("ring", 4, 1, 192, 4),
    ("ring", 3, 1, 128, 48),
    ("chunk", 2, 37, 128, 4),
    ("chunk", 2, 20, 256, 1),
    ("shuffled", 4, 9, 256, 4),
])
def test_random_positions_hold_against_the_mask(kind, B, Sq, Sk, G, seed):
    rng = np.random.default_rng(1000 * seed + B * Sq + G)
    q_pos, kv_pos, window = _random_positions(rng, kind, B, Sq, Sk)
    for causal in (True, False):
        _check(q_pos, kv_pos, G, causal, window)


def test_tile_classes_of_hand_made_tiles():
    j = torch.arange(BK)
    wrapped = 900 + (j + 17) % BK                  # 900 … 963, rolled
    assert tile_class(wrapped, 1000, 1002, True, 200) == "full"
    assert tile_class(wrapped, 940, 1002, True, 200) == "masked"
    assert tile_class(wrapped, 1000, 1002, True, 50) == "masked"
    assert tile_class(wrapped, 1100, 1200, True, 100) == "skip"
    assert tile_class(wrapped, 800, 899, True, 0) == "skip"
    assert tile_class(wrapped, 800, 899, False, 0) == "full"
    holed = torch.where(j % 7 == 0, -1, wrapped)
    assert tile_class(holed, 1000, 1002, True, 0) == "masked"
    assert tile_class(torch.full((BK,), -1), 0, 10**6, False, 0) == "skip"
    assert tile_class(wrapped, 5, 4, False, 0) == "skip"   # no rows


@pytest.mark.parametrize("R,rows", [(1, 16), (16, 16), (17, 32), (32, 32),
                                    (33, ROWS), (64, ROWS), (65, ROWS)])
def test_block_rows(R, rows):
    """16 rows or fewer: one row group, the four warps split each tile's
    keys; 17-32: two row groups of two warps; more: a warp a group."""
    assert block_rows(R) == rows
