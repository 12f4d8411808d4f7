"""The port's ``core/gmm.py`` against ``repro/core/gmm.py``.

EM is held with the reference's own k-means draws injected into the port
(threefry and Philox cannot match stream for stream), at the reference's
fit-parity tolerance 2e-3 (``tests/test_kernels.py``); log-densities and
the sampler primitives at 3e-4 / 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gmm as JG
from repro_torch.core import gmm as G

FIT_TOL = 2e-3


def _reference_kmeans_draws(key, weights, n_classes, K, d):
    """The draws ``repro.core.gmm._kmeans_init`` makes inside
    ``fit_classwise_gmms(key, …)``: per-class keys split from the client
    key, then (choice, jitter) keys split from each."""
    keys = jax.random.split(key, n_classes)
    N = weights.shape[1]

    def one(k, w):
        k_choice, k_jitter = jax.random.split(k)
        total = jnp.sum(w)
        p = jnp.where(total > 0, w / jnp.maximum(total, 1e-12), 1.0 / N)
        idx = jax.random.choice(k_choice, N, (K,), p=p, replace=True)
        return idx, jax.random.normal(k_jitter, (K, d), jnp.float32)
    idx, jit = jax.vmap(one)(keys, weights)
    return torch.from_numpy(np.array(idx)), torch.from_numpy(np.array(jit))


def _classwise_data(seed, N=90, d=6, C=3, pad=7, absent=None):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, C, N).astype(np.int32)
    if absent is not None:
        labels[labels == absent] = (absent + 1) % C
    x = (rng.randn(N, d) + 3.0 * np.eye(C, d)[labels]).astype(np.float32)
    x = np.concatenate([x, np.zeros((pad, d), np.float32)])
    labels = np.concatenate([labels, -np.ones(pad, np.int32)])
    return x, labels


class TestFitParity:
    @pytest.mark.parametrize("cov,absent", [("diag", None), ("spher", None),
                                            ("diag", 1)])
    def test_classwise_with_reference_draws(self, cov, absent):
        C, K = 3, 2
        x, labels = _classwise_data(4, C=C, absent=absent)
        cfg_j = JG.GMMConfig(n_components=K, cov_type=cov, n_iter=8)
        cfg_t = G.GMMConfig(n_components=K, cov_type=cov, n_iter=8)
        key = jax.random.PRNGKey(0)
        gj, cj, llj = JG.fit_classwise_gmms(key, x, labels, C, cfg_j)
        weights = np.asarray(jax.nn.one_hot(labels, C)).T
        idx, jit = _reference_kmeans_draws(key, weights, C, K, x.shape[1])
        gt, ct, llt = G.fit_classwise_gmms(
            torch.from_numpy(x), torch.from_numpy(labels), C, cfg_t,
            device="cpu", init_idx=idx, jitter=jit)
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
        if cov == "spher":
            assert gt["cov"].shape == (C, K)
        for f in ("pi", "mu", "cov"):
            np.testing.assert_allclose(gt[f].numpy(), np.asarray(gj[f]),
                                       rtol=FIT_TOL, atol=FIT_TOL)
        np.testing.assert_allclose(llt.numpy(), np.asarray(llj),
                                   rtol=1e-3, atol=1e-3)

    @pytest.mark.parametrize("cov", ["diag", "spher"])
    def test_fit_gmm_with_reference_draws(self, cov):
        x = np.random.RandomState(6).randn(60, 5).astype(np.float32)
        w = np.ones(60, np.float32)
        w[:7] = 0.0
        key = jax.random.PRNGKey(3)
        gj, llj = JG.fit_gmm(key, x, w, JG.GMMConfig(3, cov, n_iter=6))
        k_choice, k_jitter = jax.random.split(key)
        idx = jax.random.choice(k_choice, 60, (3,), p=w / w.sum())
        jit = jax.random.normal(k_jitter, (3, 5), jnp.float32)
        gt, llt = G.fit_gmm(torch.from_numpy(x), torch.from_numpy(w),
                            G.GMMConfig(3, cov, n_iter=6),
                            init_idx=torch.from_numpy(np.array(idx)),
                            jitter=torch.from_numpy(np.array(jit)))
        for f in ("pi", "mu", "cov"):
            np.testing.assert_allclose(gt[f].numpy(), np.asarray(gj[f]),
                                       rtol=FIT_TOL, atol=FIT_TOL)
        np.testing.assert_allclose(float(llt), float(llj), rtol=1e-3,
                                   atol=1e-3)

    def test_cohort_batched_matches_per_client(self):
        """Shared-x batching over a cohort (Bx = M, B = M·C) gives the
        per-client fits."""
        C, K = 3, 2
        cfg = G.GMMConfig(n_components=K, n_iter=5)
        data = [_classwise_data(s, C=C) for s in (1, 2)]
        feats = torch.stack([torch.from_numpy(x) for x, _ in data])
        labels = torch.stack([torch.from_numpy(y) for _, y in data])
        g = torch.Generator()
        g.manual_seed(3)
        idx = torch.randint(0, feats.shape[1], (2 * C, K), generator=g)
        jit = torch.randn(2 * C, K, feats.shape[2], generator=g)
        gb, cb, llb = G.fit_classwise_gmms_batched(
            feats, labels, C, cfg, init_idx=idx, jitter=jit)
        for m in range(2):
            gm, cm, llm = G.fit_classwise_gmms_batched(
                feats[m:m + 1], labels[m:m + 1], C, cfg,
                init_idx=idx[m * C:(m + 1) * C],
                jitter=jit[m * C:(m + 1) * C])
            for f in ("pi", "mu", "cov"):
                torch.testing.assert_close(gb[f][m], gm[f][0], rtol=1e-5,
                                           atol=1e-5)
            torch.testing.assert_close(llb[m], llm[0], rtol=1e-5, atol=1e-5)

    def test_own_generator_fits_are_finite_and_separate_classes(self):
        x, labels = _classwise_data(5)
        g = torch.Generator()
        g.manual_seed(0)
        gmm, counts, lls = G.fit_classwise_gmms(
            torch.from_numpy(x), torch.from_numpy(labels), 3,
            G.GMMConfig(n_components=2, n_iter=6), device="cpu",
            generator=g)
        assert torch.isfinite(gmm["mu"]).all() and torch.isfinite(lls).all()
        assert counts.sum() == 90          # the −1 padding rows count for 0
        centers = (gmm["pi"][..., None] * gmm["mu"]).sum(1)
        assert torch.equal(centers[:, :3].argmax(-1), torch.arange(3))


class TestDensityAndSampler:
    @pytest.mark.parametrize("cov", ["diag", "spher"])
    def test_log_prob_matches_reference(self, cov):
        rng = np.random.RandomState(0)
        x = rng.randn(40, 5).astype(np.float32)
        cov_arr = (rng.rand(3, 5) + 0.2 if cov == "diag"
                   else rng.rand(3) + 0.2).astype(np.float32)
        gmm = {"pi": np.asarray([0.2, 0.5, 0.3], np.float32),
               "mu": rng.randn(3, 5).astype(np.float32), "cov": cov_arr}
        tg = {k: torch.from_numpy(v) for k, v in gmm.items()}
        np.testing.assert_allclose(
            G.log_prob(torch.from_numpy(x), tg, cov).numpy(),
            np.asarray(JG.log_prob(x, gmm, cov)), rtol=3e-4, atol=3e-4)
        np.testing.assert_allclose(
            G.log_prob_components(torch.from_numpy(x), tg, cov).numpy(),
            np.asarray(JG.log_prob_components(x, gmm, cov)),
            rtol=3e-4, atol=3e-4)

    def test_draw_slots_matches_reference_on_the_same_uniforms(self):
        cum = jnp.asarray(np.cumsum([0.0, 3, 0, 5, 2]) / 10.0, jnp.float32)
        key = jax.random.PRNGKey(7)
        u = jax.random.uniform(key, (500,))
        exp = JG.draw_slots(key, cum, 500)
        got = G.draw_slots(torch.from_numpy(np.array(u)),
                           torch.from_numpy(np.array(cum)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(exp))

    @pytest.mark.parametrize("cov", ["diag", "spher"])
    def test_slot_gaussian_matches_reference(self, cov):
        rng = np.random.RandomState(1)
        mu = rng.randn(4, 3, 6).astype(np.float32)
        c = (rng.rand(4, 3, 6) if cov == "diag" else rng.rand(4, 3)) \
            .astype(np.float32) - 0.1          # a few negatives: clamped
        slot = rng.randint(0, 4, (2, 5))
        comp = rng.randint(0, 3, (2, 5))
        eps = rng.randn(2, 5, 6).astype(np.float32)
        exp = JG.slot_gaussian(slot, comp, eps, mu,
                               JG.sampling_factor(c, cov), cov)
        got = G.slot_gaussian(torch.from_numpy(slot), torch.from_numpy(comp),
                              torch.from_numpy(eps), torch.from_numpy(mu),
                              G.sampling_factor(torch.from_numpy(c), cov),
                              cov)
        np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=1e-6,
                                   atol=1e-6)

    @pytest.mark.parametrize("cov", ["diag", "spher"])
    def test_identity_gmm_and_wire_accounting(self, cov):
        a, b = G.identity_gmm(3, 4, cov), JG.identity_gmm(3, 4, cov)
        for f in G.WIRE_FIELDS:
            np.testing.assert_array_equal(a[f], b[f])
        for ct in ("full", "diag", "spher"):
            assert G.packed_cov_shape(ct, 3, 4) == JG.packed_cov_shape(ct, 3,
                                                                       4)
            assert G.comm_bytes(ct, 7, 3, 5) == JG.comm_bytes(ct, 7, 3, 5)
        bad = {"pi": torch.ones(2), "mu": torch.tensor([1.0, float("nan")]),
               "cov": torch.ones(2)}
        assert G.nonfinite_fields(bad) == ["mu"]


class TestTrapsAndRefusals:
    def test_minus_one_labels_one_hot_to_zero(self):
        oh = G._one_hot(torch.tensor([0, -1, 2]), 3)
        np.testing.assert_array_equal(
            oh.numpy(), np.asarray(jax.nn.one_hot(jnp.asarray([0, -1, 2]),
                                                  3)))

    def test_full_covariance_refused_with_roadmap_item(self):
        """cov_type="full" runs: a single full fit with the reference's
        k-means draws matches ``repro.core.gmm.fit_gmm`` at 2e-3."""
        x = np.random.RandomState(6).randn(60, 4).astype(np.float32)
        w = np.ones(60, np.float32)
        w[:5] = 0.0
        key = jax.random.PRNGKey(1)
        gj, llj = JG.fit_gmm(key, x, w, JG.GMMConfig(2, "full", n_iter=6))
        k_choice, k_jitter = jax.random.split(key)
        idx = jax.random.choice(k_choice, 60, (2,), p=w / w.sum())
        jit = jax.random.normal(k_jitter, (2, 4), jnp.float32)
        gt, llt = G.fit_gmm(torch.from_numpy(x), torch.from_numpy(w),
                            G.GMMConfig(2, "full", n_iter=6),
                            init_idx=torch.from_numpy(np.array(idx)),
                            jitter=torch.from_numpy(np.array(jit)))
        assert gt["cov"].shape == (2, 4, 4)
        for f in ("pi", "mu", "cov"):
            np.testing.assert_allclose(gt[f].numpy(), np.asarray(gj[f]),
                                       rtol=FIT_TOL, atol=FIT_TOL)
        np.testing.assert_allclose(float(llt), float(llj), rtol=FIT_TOL,
                                   atol=FIT_TOL)

    def test_entry_point_needs_cuda_unless_cpu_is_asked(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present")
        with pytest.raises(RuntimeError, match="CUDA"):
            G.fit_classwise_gmms(torch.randn(10, 3), torch.zeros(10).long(),
                                 2, G.GMMConfig(n_components=2))
