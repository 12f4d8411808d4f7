"""The yardstick's counts against shapes worked by hand."""
import json
from pathlib import Path

import pytest

from pftbench import workcount as W

CONFIGS = Path(__file__).resolve().parent / "configs"


@pytest.mark.parametrize("Sq, Sk, causal, window, pairs", [
    (4, 4, True, 0, 10),        # 1 + 2 + 3 + 4
    (4, 4, False, 0, 16),
    (4, 4, True, 2, 7),         # 1 + 2 + 2 + 2
    (2, 4, True, 0, 7),         # queries at positions 2, 3: 3 + 4
])
def test_visible_pairs(Sq, Sk, causal, window, pairs):
    assert W.visible_pairs(Sq, Sk, causal, window) == pairs


def test_kernel_work_by_hand():
    # flash: 4 B H pairs D; q, k, v, o of 1 x 2 x 4 x 8 in bf16
    assert W.flash_work(1, 2, 2, 4, 4, 8, causal=False) == {
        "flops": 1024.0, "bytes": 512.0, "peak": W.BF16_FLOPS}
    # ssd, L = 2: 2 B T L N + B H T (2 L P + 4 N P); x, y bf16 (2 x 16 B),
    # a f32 (16 B), B, C bf16 (48 B), both states f32 (48 B)
    assert W.ssd_work(1, 1, 4, 2, 3, chunk=2) == {
        "flops": 176.0, "bytes": 144.0, "peak": W.BF16_FLOPS}
    # estep: 4 B N K d; x, mu, var, pi read, log numerators and lse written
    assert W.estep_fused_work(1, 2, 3, 4, 5) == {
        "flops": 480.0, "bytes": 532.0, "peak": W.F32_FLOPS}
    assert W.estep_work(3, 4, 5) == W.estep_fused_work(1, 1, 3, 4, 5) | {
        "bytes": 4.0 * (15 + 40 + 4 + 12)}


def test_bound_is_the_larger_of_the_two_limits():
    w = {"flops": 989e12, "bytes": 3.35e12 / 2, "peak": W.BF16_FLOPS}
    assert W.bound_s(w) == pytest.approx(1.0)
    assert W.bound_s(w | {"bytes": 3 * 3.35e12}) == pytest.approx(3.0)


@pytest.mark.parametrize("name, seq, flops", [
    # 48 x (2 x 64 x 19 660 800 products + 4 x 16 x 80 x 64^2 attention)
    # + 2 x 64 x 512 x 1280 frame projection
    ("hubert-xlarge", 64, 121_886_474_240),
    # 81 Mamba2 layers x 128 x 157 754 368 (projections, conv, recurrence)
    # + 13 uses x (128 x 411 041 792 + 4 x 32 x 112 x 8256 causal pairs)
    ("zamba2-7b", 128, 2_321_109_483_520),
])
def test_model_flops_of_the_configurations(name, seq, flops):
    cfg = json.loads((CONFIGS / f"{name}.json").read_text())["model"]
    assert W.model_flops(cfg, seq) == flops


def test_the_esteps_bound_is_the_ems_work_however_launched():
    # 3 rounds x 2 clients x (5 E-steps + the final log-likelihood's), each
    # a client's 3 fits of 2 components over its 40 rows of d 64
    from pftbench import testing
    from pftbench.workloads import round as R
    cell = testing.cell(testing.ENCODER)
    mix, model = cell["mix"], cell["config_file"]["model"]
    one = W.bound_s(W.estep_fused_work(1, 3, 40, 2, 64))
    assert R.bound_seconds([], 3, mix, model) == {
        "estep_fused": 3 * 2 * 6 * one}
