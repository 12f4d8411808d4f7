"""The port's theory evaluators (``core/theory.py``) and reconstruction
attack (``core/reconstruction.py``) against the JAX package.

Each function is held against the reference on the same inputs (the
entropy estimate with the reference's dequantization noise) to 1e-4
relative.  The claims the reference's tests make are made again with the
port's own pipeline at the reference tests' sizes
(``tests/test_decentralized_dp_theory.py``): the Theorem 6.1 bound holds
(lhs ≤ rhs) and raw features reconstruct better than GMM samples of them.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import reconstruction as JRA
from repro.core import theory as JT
from repro_torch import data as D
from repro_torch.core import fedpft as FP
from repro_torch.core import gmm as G
from repro_torch.core import head as H
from repro_torch.core import reconstruction as RA
from repro_torch.core import theory as T

TOL = 1e-4
N_CLASSES, DIM = 6, 16


def _t(a):
    return torch.from_numpy(np.array(a))


def test_entropy_knn_with_reference_noise():
    x = np.random.RandomState(0).randn(300, 5).astype(np.float32) * 2
    key = jax.random.PRNGKey(1)
    exp = float(JT.entropy_knn(x, key=key))
    got = float(T.entropy_knn(_t(x), noise=_t(jax.random.uniform(key,
                                                                  x.shape))))
    assert abs(got - exp) <= TOL * abs(exp)
    assert abs(float(T.entropy_knn(_t(x), 0.0))
               - float(JT.entropy_knn(x, 0.0))) <= TOL * abs(exp)


def test_entropy_knn_of_a_gaussian():
    g = torch.Generator()
    g.manual_seed(0)
    x = torch.randn(2000, 4, generator=g) * 2.0
    h_true = 0.5 * 4 * math.log(2 * math.pi * math.e * 4.0)
    assert abs(float(T.entropy_knn(x, 0.0)) - h_true) < 0.3
    assert abs(float(T.entropy_knn(x, generator=g)) - h_true) < 0.3


def test_bounds_match_reference():
    rng = np.random.RandomState(2)
    args = (rng.rand(5).astype(np.float32),
            rng.rand(5).astype(np.float32) * 3 + 1,
            rng.rand(5).astype(np.float32) * 2,
            rng.randint(1, 20, 5).astype(np.float32))
    for name in ("theorem61_bound", "accuracy_lower_bound"):
        exp = float(getattr(JT, name)(*args))
        got = float(getattr(T, name)(*(_t(a) for a in args)))
        assert abs(got - exp) <= TOL * max(1.0, abs(exp)), name
    assert T.head_bytes(512, 100) == JT.head_bytes(512, 100) \
        == (100 * 512 + 100) * 2
    assert T.comm_bytes("full", 8, 2, 3) == JT.comm_bytes("full", 8, 2, 3)


def test_reconstruction_matches_reference():
    rng = np.random.RandomState(3)
    feats = rng.randn(200, 12).astype(np.float32)
    inputs = (feats @ rng.randn(12, 9) + 0.1 * rng.randn(200, 9)) \
        .astype(np.float32)
    shared = rng.randn(150, 12).astype(np.float32)
    cfg_j, cfg_t = JRA.AttackConfig(), RA.AttackConfig()
    aj = JRA.fit_inversion(feats, inputs, cfg_j)
    at = RA.fit_inversion(_t(feats), _t(inputs), cfg_t)
    for k in aj:
        np.testing.assert_allclose(at[k].numpy(), np.asarray(aj[k]),
                                   rtol=TOL, atol=TOL)
    np.testing.assert_allclose(RA.invert(at, _t(shared)).numpy(),
                               np.asarray(JRA.invert(aj, shared)),
                               rtol=TOL, atol=TOL)
    idx_j, dist_j = JRA.set_level_match(JRA.invert(aj, shared), inputs)
    idx_t, dist_t = RA.set_level_match(RA.invert(at, _t(shared)),
                                       _t(inputs))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(dist_t.numpy(), np.asarray(dist_j),
                               rtol=TOL, atol=TOL)
    mj = JRA.evaluate_attack(aj, shared, inputs, cfg_j)
    mt = RA.evaluate_attack(at, _t(shared), _t(inputs), cfg_t)
    assert mt.keys() == mj.keys()
    for k in mj:
        assert abs(mt[k] - mj[k]) <= TOL * max(1.0, abs(mj[k])), k


@pytest.fixture(scope="module")
def dataset():
    dcfg = D.DatasetConfig(n_classes=N_CLASSES, n_per_class=120,
                           input_dim=DIM, class_sep=2.0)
    return tuple(_t(a) for a in (*D.make_dataset(dcfg),
                                 *D.make_dataset(dcfg, split=1)))


def test_theorem61_bound_holds(dataset):
    """Client 0-1 loss ≤ the Theorem 6.1 right-hand side, through the
    port's v1 surface (client_update → server_aggregate)."""
    x, y, _, _ = dataset
    cfg = FP.FedPFTConfig(gmm=G.GMMConfig(2, "diag", n_iter=12),
                          head=H.HeadConfig(n_steps=250, lr=3e-3))
    g = torch.Generator()
    g.manual_seed(0)
    msg = FP.client_update(x, y, N_CLASSES, cfg, generator=g, device="cpu")
    head, info = FP.server_aggregate([msg], N_CLASSES, cfg, generator=g)
    assert info["comm_bytes"] == msg.wire_bytes("diag")
    loss, _ = H.classwise_01_loss(head, info["synthetic_feats"],
                                  info["synthetic_labels"], N_CLASSES)
    H_c = torch.stack([T.entropy_knn(x[y == c], generator=g)
                       for c in range(N_CLASSES)])
    rhs = float(T.theorem61_bound(loss, H_c, _t(msg.logliks),
                                  _t(msg.counts).float()))
    lhs = 1.0 - float(H.accuracy(head, x, y))
    assert lhs <= rhs + 1e-6, (lhs, rhs)


def test_raw_features_leak_more_than_gmm_samples():
    """§6.4's ordering at the reference test's size: raw features
    reconstruct with lower MSE and higher cosine than GMM samples."""
    dcfg = D.DatasetConfig(n_classes=4, n_per_class=400, input_dim=DIM,
                           class_sep=2.0)
    x_att, _ = D.make_dataset(dcfg)
    x_def, y_def = D.make_dataset(dcfg, split=1)
    W = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (DIM, 48))
                   / jnp.sqrt(DIM))

    def f(z):
        return torch.tanh(0.3 * _t(z) @ _t(W))
    atk = RA.fit_inversion(f(x_att), _t(x_att), RA.AttackConfig())
    m_raw = RA.evaluate_attack(atk, f(x_def), _t(x_def), RA.AttackConfig())
    g = torch.Generator()
    g.manual_seed(0)
    gm, _, _ = G.fit_classwise_gmms(f(x_def), _t(y_def), 4,
                                    G.GMMConfig(2, n_iter=10), device="cpu",
                                    generator=g)
    samp = torch.cat([G.sample({k: v[c] for k, v in gm.items()}, 200, "diag",
                               generator=g) for c in range(4)])
    m_gmm = RA.evaluate_attack(atk, samp, _t(x_def), RA.AttackConfig())
    assert m_raw["mse_all"] < m_gmm["mse_all"]
    assert m_raw["cosine_all"] > m_gmm["cosine_all"]
