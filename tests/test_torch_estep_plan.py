"""The E-step kernel's launch plan against the cells it must write.

``gmm_estep.launch_plan`` picks, per shape, the component tile, the split
of d, and the fits and rows of a block of ``csrc/gmm_estep.cu``'s kernel;
``Plan.cells`` states the kernel's index arithmetic (which thread writes
which (b, n, k), and the row logsumexp of (b, n) beside it).  Over the
card checks' shapes and a grid of small ragged ones, every (b, n, k) of
the (B, N, K) output is written exactly once, and each plan is one the
kernel takes (whole warps, at most 256 threads; shared memory; grid).  Exact: integer rules.
"""
import collections
import itertools

import pytest

from repro_torch.kernels import checks
from repro_torch.kernels import gmm_estep as GE

SMALL = [(Bx, r * Bx, N, K, d)
         for Bx, r, N, K, d in itertools.product(
             (1, 3), (1, 2, 10, 17), (5, 130), (1, 3, 10, 13, 40),
             (33, 1280))]


def _check(Bx, B, N, K, d):
    plan = GE.launch_plan(Bx, B, N, K, d)
    assert plan.threads % 32 == 0 and plan.threads <= GE.MAX_THREADS
    assert plan.k_tile in GE.K_TILES and plan.splits in GE.SPLITS
    assert plan.smem_bytes() <= GE.MAX_SMEM
    assert plan.k_tile >= K or plan.k_tile == GE.K_TILES[-1]
    cells = collections.Counter(plan.cells(Bx, B, N, K))
    assert len(cells) == B * N * K and set(cells.values()) == {1}
    assert all(0 <= b < B and 0 <= n < N and 0 <= k < K
               for b, n, k in cells)
    return plan


@pytest.mark.parametrize("tag", sorted(checks.ESTEP_CASES))
def test_card_check_shapes_are_covered_once(tag):
    Bx, B, N, K, d, _ = checks.ESTEP_CASES[tag]
    _check(Bx, B, N, K, d)


@pytest.mark.parametrize("Bx,B,N,K,d", SMALL)
def test_small_ragged_shapes_are_covered_once(Bx, B, N, K, d):
    _check(Bx, B, N, K, d)


def test_main_path_plan_takes_one_block_an_sm():
    """The client call (x (1, 1000, 1280), 10 fits of K = 10): each block
    stages 40 rows of x once for two of the fits sharing them, and the 125
    blocks fit on the 132 SMs, so no SM runs two one after the other (the
    plans with more, smaller blocks were slower on the card: PERF.md)."""
    plan = _check(1, 10, 1000, 10, 1280)
    assert (plan.k_tile, plan.fits, plan.rows) == (10, 2, 40)
    gx, gy = plan.grid(1, 10, 1000)
    assert gx * gy <= 132
