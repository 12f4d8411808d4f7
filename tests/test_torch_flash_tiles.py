"""The flash kernel's key-tile rule against the plain version's mask.

``flash_attention.key_tile_range`` decides which key tiles a query block
of the bf16 kernel visits, and ``tile_needs_mask`` on which of them it
tests each (query, key) pair; ``csrc/flash_attention.cu`` states the same
arithmetic, for a block's 64 rows and for each warp's 16.  Over a grid of
small (Sq, Sk, causal, window, prefix), every pair that
``ref.attention_mask`` (the mask of ``ref.attention_ref``) makes visible
lies in a visited tile, every visited tile outside the prefix holds a
visible pair, and a tile that takes no mask test holds only visible
pairs.  Exact: these are integer rules.
"""
import itertools

import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import (BKV, BQ, WARP_ROWS,
                                                 key_tile_range,
                                                 tile_needs_mask)

SEQS = [(1, 1), (5, 5), (64, 64), (65, 65), (130, 130), (200, 200),
        (1, 515), (70, 515), (64, 200), (200, 64)]
MASKS = [(c, w, p) for c in (True, False) for w in (0, 1, 10, 64, 100)
         for p in (0, 3, 64, 70, 130)]


def _tiles(Sq, Sk, qb, causal, window, prefix, rows=64):
    n_pre, lo, hi = key_tile_range(qb, Sq, Sk, causal, window, prefix, rows)
    assert 0 <= n_pre <= lo <= hi <= -(-Sk // BKV)
    return list(range(n_pre)) + list(range(lo, hi))


@pytest.mark.parametrize("rows", [BQ, WARP_ROWS])
@pytest.mark.parametrize("Sq,Sk", SEQS)
def test_visited_tiles_cover_every_visible_pair(Sq, Sk, rows):
    for causal, window, prefix in MASKS:
        mask = ref.attention_mask(Sq, Sk, causal=causal, window=window,
                                  prefix=prefix)
        for qb in range(-(-Sq // rows)):
            vis = mask[qb * rows:(qb + 1) * rows]
            tiles = _tiles(Sq, Sk, qb, causal, window, prefix, rows)
            seen = torch.zeros(Sk, dtype=torch.bool)
            for t in tiles:
                seen[t * BKV:(t + 1) * BKV] = True
            case = (Sq, Sk, qb, causal, window, prefix)
            assert not (vis & ~seen).any(), case
            for t in range(-(-Sk // BKV)):
                cols = vis[:, t * BKV:(t + 1) * BKV]
                if t in tiles and t * BKV >= prefix:
                    assert cols.any(), (case, t)   # no tile visited idly
                if t in tiles and not tile_needs_mask(t, qb, Sq, Sk, causal,
                                                      window, prefix, rows):
                    assert cols.all() and cols.shape[1] == BKV, (case, t)


@pytest.mark.parametrize("rows,causal,window,prefix,visited", [
    (BQ, True, 0, 0, 36),        # causal S = 512: 1 + 2 + … + 8 of 64
    (BQ, False, 0, 0, 64),       # bidirectional: the full sweep
    (BQ, True, 100, 0, 21),      # window 100: at most three tiles per block
    (BQ, True, 0, 130, 39),      # prefix 130 adds tiles 1 and 2 back
    (WARP_ROWS, True, 0, 0, 144),  # the warps: 4 (1 + … + 8) of 256
])
def test_causal_512_visits_fewer_tiles(rows, causal, window, prefix,
                                       visited):
    """zamba2-7b's shared block, S = 512: the tiles visited over the
    blocks (or warps) of queries against the 512 / rows · 8 of a full
    sweep."""
    total = sum(len(_tiles(512, 512, qb, causal, window, prefix, rows))
                for qb in range(512 // rows))
    assert total == visited


def test_tail_queries_and_empty_rows():
    # Sq = 1 at the tail of 515 keys: causal sees every tile
    assert _tiles(1, 515, 0, True, 0, 0) == list(range(9))
    # queries before the first key (Sq > Sk, causal) visit nothing
    assert _tiles(200, 64, 0, True, 0, 0) == []
    assert _tiles(200, 64, 2, True, 0, 0) == [0]
    # a block that needs no mask: bidirectional, full tiles
    assert not any(tile_needs_mask(t, 0, 64, 128, False, 0, 0)
                   for t in range(2))
    assert tile_needs_mask(3, 0, 64, 200, False, 0, 0)   # ragged last tile


def test_grid_is_exhaustive_over_its_edges():
    """The grid reaches each branch of the rule: an empty main range, a
    prefix past the main range, tail queries and a ragged last tile."""
    hits = set()
    for (Sq, Sk), (causal, window, prefix) in itertools.product(SEQS, MASKS):
        for qb in range(-(-Sq // 64)):
            n_pre, lo, hi = key_tile_range(qb, Sq, Sk, causal, window,
                                           prefix)
            hits.add("empty" if hi == 0 else "some")
            if prefix and n_pre < -(-min(prefix, Sk) // BKV):
                hits.add("prefix past lo")
            if n_pre < lo:
                hits.add("gap")
            if Sk % BKV:
                hits.add("ragged")
    assert hits == {"empty", "some", "prefix past lo", "gap", "ragged"}
