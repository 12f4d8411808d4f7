"""The port's full-covariance GMMs and their wire layout against
``repro/core/gmm.py``.

Tolerances: log-densities rtol/atol 1e-4; a full EM fit 2e-3
(``tests/test_gmm.py:157``, with the reference's k-means draws injected);
sampling factors compared as F·Fᵀ (eigenvector signs and the order of
equal eigenvalues differ between LAPACK builds) to 1e-5·‖Σ‖; draws fed
from the reference's keys 1e-5; the wire layout exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gmm as JG
from repro_torch.core import gmm as G
from test_torch_gmm import _classwise_data, _reference_kmeans_draws

FIT_TOL = 2e-3
DENS_TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _spd(rng, K, d, scale=1.0):
    a = rng.randn(K, d, d).astype(np.float32)
    return (np.einsum("kij,klj->kil", a, a) / d
            + scale * 0.2 * np.eye(d, dtype=np.float32)).astype(np.float32)


def _full_gmm(seed, K=3, d=6):
    rng = np.random.RandomState(seed)
    logits = rng.randn(K)
    return {"pi": (np.exp(logits) / np.exp(logits).sum()).astype(np.float32),
            "mu": rng.randn(K, d).astype(np.float32),
            "cov": _spd(rng, K, d)}


class TestDensity:
    def test_log_prob_matches_reference(self):
        gmm = _full_gmm(0)
        x = np.random.RandomState(1).randn(50, 6).astype(np.float32)
        tg = {k: _t(v) for k, v in gmm.items()}
        np.testing.assert_allclose(
            G.log_prob_components(_t(x), tg, "full").numpy(),
            np.asarray(JG.log_prob_components(x, gmm, "full")),
            rtol=DENS_TOL, atol=DENS_TOL)
        np.testing.assert_allclose(
            G.log_prob(_t(x), tg, "full").numpy(),
            np.asarray(JG.log_prob(x, gmm, "full")),
            rtol=DENS_TOL, atol=DENS_TOL)

    def test_non_pd_component_gives_nan_like_the_reference(self):
        """``jnp.linalg.cholesky`` returns NaN for a matrix that is not
        positive definite; the port keeps that (``torch.linalg.cholesky``
        alone would raise) and leaves the other components exact."""
        gmm = _full_gmm(2)
        gmm["cov"][1] = -np.eye(6, dtype=np.float32)
        x = np.random.RandomState(3).randn(20, 6).astype(np.float32)
        exp = np.asarray(JG.log_prob_components(x, gmm, "full"))
        got = G.log_prob_components(_t(x), {k: _t(v) for k, v in
                                            gmm.items()}, "full").numpy()
        assert np.isnan(exp[:, 1]).all() and np.isnan(got[:, 1]).all()
        np.testing.assert_allclose(got[:, [0, 2]], exp[:, [0, 2]],
                                   rtol=DENS_TOL, atol=DENS_TOL)
        with pytest.raises(RuntimeError):
            torch.linalg.cholesky(_t(gmm["cov"]))


class TestFit:
    @pytest.mark.parametrize("absent", [None, 1])
    def test_classwise_full_fit_with_reference_draws(self, absent):
        C, K = 3, 2
        x, labels = _classwise_data(7, N=120, d=5, C=C, absent=absent)
        cfg_j = JG.GMMConfig(n_components=K, cov_type="full", n_iter=8)
        cfg_t = G.GMMConfig(n_components=K, cov_type="full", n_iter=8)
        key = jax.random.PRNGKey(4)
        gj, cj, llj = JG.fit_classwise_gmms(key, x, labels, C, cfg_j)
        weights = np.asarray(jax.nn.one_hot(labels, C)).T
        idx, jit = _reference_kmeans_draws(key, weights, C, K, x.shape[1])
        gt, ct, llt = G.fit_classwise_gmms(_t(x), _t(labels), C, cfg_t,
                                           device="cpu", init_idx=idx,
                                           jitter=jit)
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
        assert gt["cov"].shape == (C, K, 5, 5)
        for f in ("pi", "mu", "cov"):
            np.testing.assert_allclose(gt[f].numpy(), np.asarray(gj[f]),
                                       rtol=FIT_TOL, atol=FIT_TOL)
        np.testing.assert_allclose(llt.numpy(), np.asarray(llj),
                                   rtol=FIT_TOL, atol=FIT_TOL)

    def test_shared_blocks_match_per_client_fits(self):
        """A cohort's full fits over shared feature blocks (Bx = M) equal
        each client's own fit."""
        C, K = 3, 2
        cfg = G.GMMConfig(n_components=K, cov_type="full", n_iter=4)
        data = [_classwise_data(s, N=60, d=4, C=C) for s in (1, 2)]
        feats = torch.stack([_t(x) for x, _ in data])
        labels = torch.stack([_t(y) for _, y in data])
        g = torch.Generator()
        g.manual_seed(5)
        idx = torch.randint(0, feats.shape[1], (2 * C, K), generator=g)
        jit = torch.randn(2 * C, K, 4, generator=g)
        gb, _, llb = G.fit_classwise_gmms_batched(feats, labels, C, cfg,
                                                  init_idx=idx, jitter=jit)
        for m in range(2):
            gm, _, llm = G.fit_classwise_gmms_batched(
                feats[m:m + 1], labels[m:m + 1], C, cfg,
                init_idx=idx[m * C:(m + 1) * C],
                jitter=jit[m * C:(m + 1) * C])
            for f in ("pi", "mu", "cov"):
                torch.testing.assert_close(gb[f][m], gm[f][0], rtol=1e-5,
                                           atol=1e-5)
            torch.testing.assert_close(llb[m], llm[0], rtol=1e-5, atol=1e-5)


class TestSampler:
    @pytest.mark.parametrize("shift", [0.2, -0.05])
    def test_sampling_factor_as_f_ft(self, shift):
        """F·Fᵀ = Proj_PSD(Σ) on a PD stack and on one with negative
        eigenvalues (clamped at 0)."""
        rng = np.random.RandomState(8)
        a = rng.randn(2, 3, 7, 7).astype(np.float32)
        cov = (a @ np.swapaxes(a, -1, -2) / 7 - 0.3
               * np.eye(7, dtype=np.float32) + shift).astype(np.float32)
        cov = 0.5 * (cov + np.swapaxes(cov, -1, -2))
        fj = np.asarray(JG.sampling_factor(cov, "full"))
        ft = G.sampling_factor(_t(cov), "full").numpy()
        tol = 1e-5 * float(np.linalg.norm(cov, axis=(-2, -1)).max())
        np.testing.assert_allclose(ft @ np.swapaxes(ft, -1, -2),
                                   fj @ np.swapaxes(fj, -1, -2), atol=tol)

    def test_grouped_noise_equals_the_gathered_form(self):
        """``factor_noise`` groups the draws by (slot, component) and
        multiplies each group once; the gathered form takes one d × d
        factor per draw.  The same draws give the same numbers up to
        summation order."""
        rng = np.random.RandomState(9)
        Gs, K, d = 5, 3, 12
        fac = G.sampling_factor(_t(_spd(rng, Gs * K, d)), "full") \
            .reshape(Gs, K, d, d)
        mu = _t(rng.randn(Gs, K, d).astype(np.float32))
        slot = _t(rng.randint(0, Gs, (4, 33)))
        comp = _t(rng.randint(0, K, (4, 33)))
        eps = _t(rng.randn(4, 33, d).astype(np.float32))
        got = G.slot_gaussian(slot, comp, eps, mu, fac, "full")
        exp = mu[slot, comp] + G.colored_noise(fac[slot, comp], eps, "full")
        torch.testing.assert_close(got, exp, rtol=1e-5, atol=1e-5)
        ref = JG.slot_gaussian(slot.numpy(), comp.numpy(), eps.numpy(),
                               mu.numpy(), fac.numpy(), "full")
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)

    @pytest.mark.parametrize("cov_type", ["full", "diag"])
    def test_sample_with_reference_draws(self, cov_type):
        """diag: the reference's draws give the reference's samples.  full:
        the factor is U·√λ, whose eigenvector signs differ between LAPACK
        builds, so the same eps gives a differently rotated draw; each
        draw's Mahalanobis norm under Σ is still exactly ‖eps‖²."""
        rng = np.random.RandomState(10)
        gmm = _full_gmm(10, K=3, d=5)
        if cov_type == "diag":
            gmm["cov"] = rng.rand(3, 5).astype(np.float32) + 0.1
        key = jax.random.PRNGKey(2)
        exp = np.asarray(JG.sample(key, gmm, 64, cov_type))
        kc, kn = jax.random.split(key)
        comp = jax.random.categorical(
            kc, jnp.log(jnp.clip(jnp.asarray(gmm["pi"]), 1e-20)), shape=(64,))
        eps = np.asarray(jax.random.normal(kn, (64, 5), jnp.float32))
        got = G.sample({k: _t(v) for k, v in gmm.items()}, 64, cov_type,
                       comp=_t(comp), eps=_t(eps)).numpy()
        if cov_type == "diag":
            np.testing.assert_allclose(got, exp, rtol=1e-5, atol=1e-5)
            return
        comp = np.asarray(comp)
        for x in (got, exp):
            diff = x - gmm["mu"][comp]
            maha = np.einsum("nd,nd->n", diff, np.linalg.solve(
                gmm["cov"][comp], diff[..., None])[..., 0])
            np.testing.assert_allclose(maha, (eps ** 2).sum(-1), rtol=1e-3)

    @pytest.mark.parametrize("cov_type", ["full", "diag"])
    def test_sample_slot_minibatch_with_reference_draws(self, cov_type):
        rng = np.random.RandomState(11)
        Gs, K, d, n = 4, 2, 5, 40
        pi = rng.dirichlet(np.ones(K), Gs).astype(np.float32)
        mu = rng.randn(Gs, K, d).astype(np.float32)
        cov = (_spd(rng, Gs * K, d).reshape(Gs, K, d, d) if cov_type == "full"
               else rng.rand(Gs, K, d).astype(np.float32) + 0.1)
        counts = np.asarray([3, 0, 5, 2], np.float32)
        cum = np.cumsum(counts) / counts.sum()
        labels = np.asarray([0, 1, 1, 2])
        fj = JG.sampling_factor(cov, cov_type)
        key = jax.random.PRNGKey(6)
        xj, yj = JG.sample_slot_minibatch(key, jnp.asarray(cum), pi, mu, fj,
                                          labels, n, cov_type)
        ks, kc, kn = jax.random.split(key, 3)
        slot = JG.draw_slots(ks, jnp.asarray(cum), n)
        draws = {"u": _t(jax.random.uniform(ks, (n,))),
                 "comp": _t(jax.random.categorical(
                     kc, jnp.log(jnp.clip(jnp.asarray(pi)[slot], 1e-20)),
                     axis=-1)),
                 "eps": _t(jax.random.normal(kn, (n, d), jnp.float32))}
        # both sides take the reference's factor: eigenvector signs differ
        xt, yt = G.sample_slot_minibatch(
            _t(cum.astype(np.float32)), _t(pi), _t(mu), _t(fj), _t(labels),
            n, cov_type, draws=draws)
        np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-4,
                                   atol=1e-4)

    def test_identity_gmm_full_is_the_reference_pad(self):
        a, b = G.identity_gmm(2, 4, "full"), JG.identity_gmm(2, 4, "full")
        for f in G.WIRE_FIELDS:
            np.testing.assert_array_equal(a[f], b[f])
        fac = G.sampling_factor(_t(a["cov"]), "full")
        torch.testing.assert_close(fac @ fac.transpose(-1, -2),
                                   _t(a["cov"]))


class TestTrilWire:
    def test_tril_pack_and_unpack_numpy_and_tensor(self):
        rng = np.random.RandomState(12)
        cov = _spd(rng, 6, 5).reshape(2, 3, 5, 5)
        pj = np.asarray(JG.tril_pack(cov))
        pn = G.tril_pack(cov)
        assert isinstance(pn, np.ndarray)
        np.testing.assert_array_equal(pn, pj)
        pt = G.tril_pack(_t(cov))
        assert isinstance(pt, torch.Tensor)
        np.testing.assert_array_equal(pt.numpy(), pj)
        un = G.tril_unpack(pn, 5)
        assert isinstance(un, np.ndarray)
        np.testing.assert_array_equal(un, JG.tril_unpack(pj, 5))
        np.testing.assert_array_equal(G.tril_unpack(pt, 5).numpy(),
                                      np.asarray(JG.tril_unpack(
                                          jnp.asarray(pj), 5)))

    def test_pack_wire_matches_reference(self):
        gmm = {k: v[None] for k, v in _full_gmm(13, K=2, d=4).items()}
        pj = JG.pack_wire({k: jnp.asarray(v) for k, v in gmm.items()},
                          "full")
        pt = G.pack_wire({k: _t(v) for k, v in gmm.items()}, "full")
        for f in G.WIRE_FIELDS:
            np.testing.assert_array_equal(
                pt[f].float().numpy(), np.asarray(pj[f], np.float32))
        uj = JG.unpack_wire(pj, "full", 4)
        ut = G.unpack_wire(pt, "full", 4)
        for f in G.WIRE_FIELDS:
            np.testing.assert_array_equal(ut[f].numpy(), np.asarray(uj[f]))
