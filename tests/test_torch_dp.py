"""The port's DP-FedPFT (``core/dp.py``) against ``repro/core/dp.py``.

The mechanism is held with the reference's own Gaussian draws injected:
the symmetric noise exactly, ``project_psd`` and the privatized (mu, Σ)
to 1e-4.  The port's own draws are held in law (every element of the Σ
noise at std σ within 5 %, the reference test's bar).  The session path
is held to ``comm_bytes == Σ len(payload)``.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dp as JDP
from repro_torch import data as D
from repro_torch.core import dp as DP
from repro_torch.core import fedpft as FP
from repro_torch.core import gmm as G
from repro_torch.core import head as H
from repro_torch.fl import api as A

PSD_TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _reference_classwise_draws(key, C, d):
    """The draws ``repro.core.dp.privatize_classwise`` makes from ``key``."""
    mu_eps, raw = [], []
    for k in jax.random.split(key, C):
        k1, k2 = jax.random.split(k)
        mu_eps.append(jax.random.normal(k1, (d,), jnp.float32))
        raw.append(jax.random.normal(k2, (d, d), jnp.float32))
    return {"mu_eps": _t(jnp.stack(mu_eps)), "raw": _t(jnp.stack(raw))}


def test_noise_scale_formula():
    n, eps, delta = 500, 1.0, 1e-3
    assert DP.noise_scale(n, eps, delta) == JDP.noise_scale(n, eps, delta)
    assert abs(DP.noise_scale(n, eps, delta) - 4.0 / (n * eps)
               * math.sqrt(5 * math.log(4 / delta))) < 1e-12
    counts = np.asarray([1.0, 10.0, 100.0])
    np.testing.assert_allclose(DP.noise_scale(counts, eps, delta),
                               JDP.noise_scale(counts, eps, delta))


def test_symmetric_noise_with_reference_draw():
    key = jax.random.PRNGKey(3)
    exp = JDP.symmetric_noise(key, 6, 0.7)
    got = DP.symmetric_noise(6, 0.7,
                             raw=_t(jax.random.normal(key, (6, 6))))
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))


def test_symmetric_noise_std_is_sigma_everywhere():
    """Every element, diagonal and off-diagonal, at std σ: the
    ``0.5·(E + Eᵀ)`` symmetrization would leave the off-diagonals at
    σ/√2."""
    d, R, sigma = 8, 4000, 1.3
    g = torch.Generator()
    g.manual_seed(0)
    draws = DP.symmetric_noise(d, sigma, raw=torch.randn(R, d, d,
                                                         generator=g))
    assert torch.equal(draws, draws.transpose(-1, -2))
    std = draws.std(0).numpy()
    off = std[~np.eye(d, dtype=bool)]
    assert abs(off.mean() - sigma) < 0.05 * sigma
    assert abs(std[np.eye(d, dtype=bool)].mean() - sigma) < 0.05 * sigma
    assert (off > 0.9 * sigma).all()
    one = DP.symmetric_noise(d, sigma, generator=g)
    assert one.shape == (d, d) and torch.equal(one, one.T)


def test_project_psd_matches_reference_and_is_idempotent():
    a = np.random.RandomState(0).randn(3, 8, 8).astype(np.float32)
    sym = a + np.swapaxes(a, -1, -2) - 3.0 * np.eye(8, dtype=np.float32)
    for floor in (0.0, 1e-3):
        exp = np.stack([np.asarray(JDP.project_psd(s, floor)) for s in sym])
        got = DP.project_psd(_t(sym), floor).numpy()
        np.testing.assert_allclose(got, exp, rtol=PSD_TOL, atol=PSD_TOL)
        assert (np.linalg.eigvalsh(got) >= floor - 1e-5).all()
    psd = a @ np.swapaxes(a, -1, -2)
    np.testing.assert_allclose(DP.project_psd(_t(psd)).numpy(), psd,
                               rtol=PSD_TOL, atol=PSD_TOL)


def test_privatize_gaussian_with_reference_draws():
    d, n = 6, 50
    rng = np.random.RandomState(1)
    mu = rng.randn(d).astype(np.float32) * 0.1
    a = rng.randn(d, d).astype(np.float32)
    cov = (a @ a.T / d).astype(np.float32)
    cfg_j, cfg_t = JDP.DPConfig(epsilon=2.0), DP.DPConfig(epsilon=2.0)
    key = jax.random.PRNGKey(5)
    mj, cj = JDP.privatize_gaussian(key, mu, cov, n, cfg_j)
    k1, k2 = jax.random.split(key)
    draws = {"mu_eps": _t(jax.random.normal(k1, (d,), jnp.float32)),
             "raw": _t(jax.random.normal(k2, (d, d), jnp.float32))}
    mt, ct = DP.privatize_gaussian(_t(mu), _t(cov), n, cfg_t, draws=draws)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=PSD_TOL,
                               atol=PSD_TOL)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=PSD_TOL,
                               atol=PSD_TOL)


def test_privatize_classwise_per_class_sigma_with_reference_draws():
    d, C = 8, 4
    gmms = {"pi": np.ones((C, 1), np.float32),
            "mu": np.zeros((C, 1, d), np.float32),
            "cov": np.tile(0.5 * np.eye(d, dtype=np.float32)[None, None],
                           (C, 1, 1, 1))}
    counts = np.asarray([10 ** 6, 5, 10 ** 6, 0])
    cfg_j = JDP.DPConfig(epsilon=1.0, delta=1e-3)
    key = jax.random.PRNGKey(7)
    pj = JDP.privatize_classwise(key, gmms, counts, cfg_j)
    pt = DP.privatize_classwise({k: _t(v) for k, v in gmms.items()},
                                _t(counts), DP.DPConfig(1.0, 1e-3),
                                draws=_reference_classwise_draws(key, C, d))
    for f in G.WIRE_FIELDS:
        np.testing.assert_allclose(pt[f].numpy(), np.asarray(pj[f]),
                                   rtol=PSD_TOL, atol=PSD_TOL)
    err = pt["mu"][:, 0].abs().amax(-1).numpy()
    assert err[0] < 1e-3 and err[2] < 1e-3 and err[1] > 0.1


@pytest.fixture(scope="module")
def clients():
    dcfg = D.DatasetConfig(n_classes=4, n_per_class=60, input_dim=8,
                           class_sep=3.0)
    x, y = D.make_dataset(dcfg)
    return [(torch.from_numpy(x[p]), torch.from_numpy(y[p]))
            for p in D.iid_shards(len(y), 2)]


def test_run_dp_fedpft_counts_every_payload_byte(clients):
    cfg = FP.FedPFTConfig(gmm=G.GMMConfig(1, "full", n_iter=4),
                          head=H.HeadConfig(n_steps=40))
    head, info = DP.run_dp_fedpft(clients, 4, cfg, DP.DPConfig(), seed=0,
                                  device="cpu")
    assert info["comm_bytes"] == sum(len(m.payload)
                                     for m in info["messages"])
    assert info["comm_bytes"] == 2 * G.comm_bytes("full", 8, 1, 4)
    assert all(torch.isfinite(v).all() for v in head.values())
    # every class dropped: the clean empty-cohort head
    head, info = DP.run_dp_fedpft(clients, 4, cfg, DP.DPConfig(),
                                  min_class_count=10 ** 6, device="cpu")
    assert info["empty_cohort"] and info["comm_bytes"] == 0


def test_dp_needs_k1_full_and_the_star(clients):
    with pytest.raises(ValueError, match="Theorem 4.1"):
        DP.run_dp_fedpft(clients, 4, FP.FedPFTConfig(), DP.DPConfig(),
                         device="cpu")
    sess = A.FedSession(n_classes=4, dp=DP.DPConfig(),
                        summarizer=A.GMMSummarizer(G.GMMConfig(2, "diag")))
    with pytest.raises(ValueError, match="Theorem 4.1"):
        sess.run(clients, device="cpu")
    chain = A.FedSession(n_classes=4, dp=DP.DPConfig(), topology=A.Chain(),
                         summarizer=A.GMMSummarizer(G.GMMConfig(1, "full")))
    with pytest.raises(NotImplementedError, match="Star topology"):
        chain.run(clients, device="cpu")
