"""The traffic's frozen copies against the program's generators, and the seed's
hold on the traffic."""
import numpy as np
import pytest
import torch

from pftbench import testing, traffic

BIG = 2**31 + 4099


def test_make_dataset_is_the_programs():
    from repro_torch import data as D
    want = D.make_dataset(D.DatasetConfig(n_classes=10, n_per_class=21,
                                          input_dim=64, class_sep=3.0,
                                          seed=123), split=2)
    got = traffic.make_dataset(10, 21, 64, 3.0, 123, split=2)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_iid_shards_are_the_programs():
    from repro_torch import data as D
    for a, b in zip(traffic.iid_shards(103, 4, seed=9),
                    D.iid_shards(103, 4, seed=9)):
        assert np.array_equal(a, b)


def test_frames_and_tokens_are_the_smokes():
    x = np.random.RandomState(0).randn(5, 32).astype(np.float32) * 3
    per = 32 // 8
    want = np.pad(x.reshape(5, 8, per), ((0, 0), (0, 0), (0, 16 - per)))
    got = traffic.frames_of(torch.from_numpy(x), 8, 16)
    assert np.array_equal(got.numpy(), want)
    ids = 1 + np.clip(np.floor((x + 6.0) / 12.0 * 4).astype(np.int64), 0, 3)
    assert np.array_equal(traffic.tokens_of(torch.from_numpy(x)).numpy(), ids)


@pytest.mark.parametrize("model", [testing.ENCODER, testing.HYBRID])
def test_one_seed_fixes_the_traffic_and_two_differ(model):
    mix = testing.cell(model)["mix"]
    a, b = traffic.round_inputs(mix, BIG, 1), traffic.round_inputs(mix, BIG, 1)
    c = traffic.round_inputs(mix, BIG + 1, 1)
    assert np.array_equal(a["x"], b["x"])
    assert all(np.array_equal(p, q) for p, q in zip(a["clients"],
                                                    b["clients"]))
    assert not np.array_equal(a["x"], c["x"])
    # every seed: the same sizes, the clients cover the rows once
    n = mix["n_clients"] * mix["rows_per_client"]
    assert a["x"].shape == c["x"].shape == (n, mix["input_dim"])
    assert np.array_equal(np.sort(np.concatenate(c["clients"])),
                          np.arange(n))
    # the next round of the pool draws new noise on the same geometry
    d = traffic.round_inputs(mix, BIG, 2)
    assert not np.array_equal(a["x"], d["x"])


def test_sub_seeds_take_large_seeds_and_differ_by_path():
    seeds = {traffic.sub_seed(BIG, *p) for p in ((0,), (1, 0), (1, 1), (2,))}
    assert len(seeds) == 4 and all(0 <= s < 2**63 for s in seeds)


def test_one_seed_fixes_the_open_loop_and_two_differ():
    mix = testing.service_cell()["mix"]
    a = traffic.open_loop(mix, BIG, 2.0)
    b = traffic.open_loop(mix, BIG, 2.0)
    c = traffic.open_loop(mix, BIG + 1, 2.0)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["length"], c["length"])
    assert not np.array_equal(a["due"], c["due"])
    # every seed: the same set of lengths, gaps and kinds in another order
    n = int(round(mix["rate"] * 2.0))
    assert len(a["due"]) == len(c["due"]) == n
    assert np.array_equal(np.sort(a["length"]), np.sort(c["length"]))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / mix["rate"]
    for p in (a, c):            # each gap one of the exponential quantiles
        d = np.diff(p["due"])
        assert np.abs(d[:, None] - gaps[None]).min(1).max() < 1e-9
    assert a["kind"].sum() == c["kind"].sum() == round(n * mix["infer_share"])
    assert mix["len_min"] <= a["length"].min() <= a["length"].max() \
        <= mix["len_max"]
    # extraction requests form clients of rows_per_client in due order
    ext = a["client"][a["kind"] == 0]
    assert np.array_equal(ext, np.arange(len(ext)) // mix["rows_per_client"])
    assert (a["client"][a["kind"] == 1] == -1).all()
