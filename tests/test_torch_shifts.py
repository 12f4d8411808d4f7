"""The port's §5.3 shift splits against ``repro/data/__init__.py``.

The splits are host numpy code copied from the reference, so the same
seeds must give bit-identical arrays (tolerance: none, compared with
``assert_array_equal``).  The bars of ``tests/test_substrate.py:81-100``
are held again, and ``tests/test_fedpft.py``'s two-client label-shift run
goes through the port's ``run_fedpft`` on the CPU with its bars
(acc > 0.8, each half > 0.6).
"""
import numpy as np
import pytest
import torch

from repro import data as JD
from repro_torch import data as D
from repro_torch.core import fedpft as FP
from repro_torch.core import gmm as G
from repro_torch.core import head as H


@pytest.mark.parametrize("n_classes,seed", [(6, 0), (7, 3), (10, 11)])
def test_disjoint_label_split_is_the_references(n_classes, seed):
    _, y = D.make_dataset(D.DatasetConfig(n_classes=n_classes,
                                          n_per_class=10, seed=seed))
    src, dst = D.disjoint_label_split(y)
    jsrc, jdst = JD.disjoint_label_split(y)
    np.testing.assert_array_equal(src, jsrc)
    np.testing.assert_array_equal(dst, jdst)
    C = n_classes
    assert set(y[src]) == set(range(C // 2))
    assert set(y[dst]) == set(range(C // 2, C))


@pytest.mark.parametrize("seed", [0, 5])
def test_covariate_shift_pair_is_the_references(seed):
    kw = dict(n_classes=4, n_per_class=50, input_dim=16, n_domains=2,
              domain_shift=1.0, seed=seed)
    (xa, ya), (xb, yb) = D.covariate_shift_pair(D.DatasetConfig(**kw))
    (jxa, jya), (jxb, jyb) = JD.covariate_shift_pair(JD.DatasetConfig(**kw))
    for got, want in ((xa, jxa), (ya, jya), (xb, jxb), (yb, jyb)):
        np.testing.assert_array_equal(got, np.asarray(want))
    # tests/test_substrate.py: same labels, different marginals
    assert set(ya) == set(yb)
    assert float(np.linalg.norm(xa.mean(0) - xb.mean(0))) > 0.5
    with pytest.raises(ValueError, match="two domains"):
        D.covariate_shift_pair(D.DatasetConfig(n_domains=1))


@pytest.mark.parametrize("ca,cb,seed", [(3, 4, 0), (5, 5, 2)])
def test_task_shift_pair_is_the_references(ca, cb, seed):
    a = dict(n_classes=ca, n_per_class=10, seed=seed)
    b = dict(n_classes=cb, n_per_class=10, seed=seed)
    (xa, ya), (xb, yb), C = D.task_shift_pair(D.DatasetConfig(**a),
                                              D.DatasetConfig(**b))
    (jxa, jya), (jxb, jyb), jC = JD.task_shift_pair(JD.DatasetConfig(**a),
                                                    JD.DatasetConfig(**b))
    assert C == jC == ca + cb
    for got, want in ((xa, jxa), (ya, jya), (xb, jxb), (yb, jyb)):
        np.testing.assert_array_equal(got, np.asarray(want))
    assert yb.dtype == np.int32
    assert int(yb.min()) == ca and int(yb.max()) == ca + cb - 1
    # B is drawn from seed + 7919, not from A's seed
    xb_same_seed, _ = D.make_dataset(D.DatasetConfig(**b))
    assert not np.array_equal(xb, xb_same_seed)


def test_label_shift_run_fedpft_learns_both_halves():
    """``tests/test_fedpft.py::test_disjoint_label_shift`` through the
    port: each client holds half the labels; the global head covers all."""
    n_classes = 8
    dcfg = D.DatasetConfig(n_classes=n_classes, n_per_class=150,
                           input_dim=24, class_sep=2.0, noise=1.0)
    x, y = D.make_dataset(dcfg)
    xt, yt = D.make_dataset(dcfg, split=1)
    src, dst = D.disjoint_label_split(y)
    clients = [(torch.from_numpy(x[src]), torch.from_numpy(y[src])),
               (torch.from_numpy(x[dst]), torch.from_numpy(y[dst]))]
    cfg = FP.FedPFTConfig(
        gmm=G.GMMConfig(n_components=3, cov_type="diag", n_iter=15),
        head=H.HeadConfig(n_steps=300, lr=3e-3))
    head, _ = FP.run_fedpft(clients, n_classes, cfg, device="cpu")
    xt, yt = torch.from_numpy(xt), torch.from_numpy(yt)
    lo = yt < n_classes // 2
    acc = float(H.accuracy(head, xt, yt))
    acc_lo = float(H.accuracy(head, xt[lo], yt[lo]))
    acc_hi = float(H.accuracy(head, xt[~lo], yt[~lo]))
    assert acc > 0.8 and acc_lo > 0.6 and acc_hi > 0.6, (acc, acc_lo,
                                                        acc_hi)
