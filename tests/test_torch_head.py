"""The port's ``core/head.py`` and ``optim`` against the JAX package.

The fused server phase is held with the reference's own draws injected
(head init, ``slot_all``, ``comp_all`` and every noise window's eps): the
heads must agree to 1e-4 after ``n_steps`` Adam steps.  Adam alone is held
to 1e-6 per step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.core import gmm as JG
from repro.core import head as JH
from repro_torch import optim
from repro_torch.core import head as H

HEAD_TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _reference_fused_draws(key, pi, counts, cfg, d, n_classes):
    """Every draw ``repro.core.head.fused_gmm_steps`` makes from ``key``."""
    bs = cfg.batch_size
    W = max(1, min(cfg.noise_window, cfg.n_steps))
    n_win, tail = divmod(cfg.n_steps, W)
    mass = jnp.asarray(counts, jnp.float32)
    cum_mass = jnp.cumsum(mass) / jnp.maximum(jnp.sum(mass), 1e-9)
    k_init, k_slot, k_comp, k_eps = jax.random.split(key, 4)
    slot_all = JG.draw_slots(k_slot, cum_mass, cfg.n_steps * bs)
    logits = jnp.log(jnp.clip(jnp.asarray(pi, jnp.float32), 1e-20))
    comp_all = jax.random.categorical(k_comp, logits[slot_all], axis=-1)
    eps = [jax.random.normal(k, (W, bs, d), jnp.float32)
           for k in jax.random.split(k_eps, n_win)] if n_win else []
    if tail:
        eps.append(jax.random.normal(jax.random.fold_in(k_eps, n_win),
                                     (tail, bs, d), jnp.float32))
    return {"init": _t(jax.random.normal(k_init, (d, n_classes),
                                         jnp.float32)),
            "slot_all": _t(slot_all), "comp_all": _t(comp_all),
            "eps": _t(jnp.concatenate(eps))}


def _slot_stack(seed, G=6, K=3, d=8, C=3, cov="diag"):
    rng = np.random.RandomState(seed)
    logits = rng.randn(G, K)
    pi = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)) \
        .astype(np.float32)
    mu = (rng.randn(G, K, d) + 2.0 * np.eye(C, d)[np.arange(G) % C][:, None]) \
        .astype(np.float32)
    cov_arr = (rng.rand(G, K, d) if cov == "diag" else rng.rand(G, K)) \
        .astype(np.float32) + 0.1
    labels = (np.arange(G) % C).astype(np.int32)
    counts = rng.randint(1, 20, G).astype(np.int64)
    return pi, mu, cov_arr, labels, counts


class TestFusedHeadParity:
    @pytest.mark.parametrize("cov,n_steps,window", [("diag", 40, 16),
                                                    ("spher", 24, 24)])
    def test_head_after_n_steps_with_reference_draws(self, cov, n_steps,
                                                     window):
        C, d = 3, 8
        pi, mu, c, labels, counts = _slot_stack(0, d=d, C=C, cov=cov)
        cfg_j = JH.HeadConfig(n_steps=n_steps, batch_size=32, lr=3e-3,
                              noise_window=window, weight_decay=1e-3)
        cfg_t = H.HeadConfig(n_steps=n_steps, batch_size=32, lr=3e-3,
                             noise_window=window, weight_decay=1e-3)
        key = jax.random.PRNGKey(11)
        hj, lj = JH.train_head_from_gmms(key, pi, mu, c, labels, counts, C,
                                         cfg_j, cov)
        draws = _reference_fused_draws(key, pi, counts, cfg_j, d, C)
        ht, lt = H.train_head_from_gmms(
            _t(pi), _t(mu), _t(c), _t(labels), _t(counts), C, cfg_t, cov,
            device="cpu", draws=draws)
        for f in ("w", "b"):
            np.testing.assert_allclose(ht[f].numpy(), np.asarray(hj[f]),
                                       rtol=HEAD_TOL, atol=HEAD_TOL)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=HEAD_TOL,
                                   atol=HEAD_TOL)

    def test_own_generator_law_learns_the_classes(self):
        """The port's own draws: the head separates the slot classes."""
        pi, mu, c, labels, counts = _slot_stack(1, G=9, d=8, C=3)
        g = torch.Generator()
        g.manual_seed(0)
        head, losses = H.train_head_from_gmms(
            _t(pi), _t(mu), _t(c), _t(labels), _t(counts), 3,
            H.HeadConfig(n_steps=150, batch_size=64, lr=1e-2), "diag",
            device="cpu", generator=g)
        assert losses.shape == (150,)
        assert losses[-10:].mean() < losses[:10].mean()
        rng = np.random.RandomState(5)
        slot = rng.randint(0, 9, 300)
        comp = np.asarray([rng.choice(3, p=pi[s] / pi[s].sum())
                           for s in slot])
        x = mu[slot, comp] + np.sqrt(c[slot, comp]) * rng.randn(300, 8)
        acc = float(H.accuracy(head, _t(x.astype(np.float32)),
                               _t(labels[slot])))
        assert acc > 0.8, acc

    def test_empty_cohort_returns_the_initialized_head(self):
        pi, mu, c, labels, _ = _slot_stack(2)
        g = torch.Generator()
        g.manual_seed(0)
        head, losses = H.train_head_from_gmms(
            _t(pi), _t(mu), _t(c), _t(labels), torch.zeros(6).long(), 3,
            H.HeadConfig(), "diag", device="cpu", generator=g)
        assert losses.shape == (0,) and torch.all(head["b"] == 0)
        with pytest.raises(ValueError, match="one label and one draw count"):
            H.train_head_from_gmms(_t(pi), _t(mu), _t(c), _t(labels[:2]),
                                   torch.ones(6).long(), 3, H.HeadConfig(),
                                   "diag", device="cpu", generator=g)


class TestCentralizedAndOptim:
    def test_train_head_with_reference_draws(self):
        rng = np.random.RandomState(3)
        feats = rng.randn(50, 6).astype(np.float32)
        labels = rng.randint(0, 4, 50).astype(np.int32)
        cfg_j = JH.HeadConfig(n_steps=30, batch_size=16, lr=5e-3)
        cfg_t = H.HeadConfig(n_steps=30, batch_size=16, lr=5e-3)
        key = jax.random.PRNGKey(2)
        hj, lj = JH.train_head(key, feats, labels, 4, cfg_j)
        k_init, k_steps = jax.random.split(key)
        idx = jax.vmap(lambda k: jax.random.randint(k, (16,), 0, 50))(
            jax.random.split(k_steps, 30))
        draws = {"init": _t(jax.random.normal(k_init, (6, 4), jnp.float32)),
                 "idx": _t(idx)}
        ht, lt = H.train_head(_t(feats), _t(labels), 4, cfg_t, draws=draws)
        for f in ("w", "b"):
            np.testing.assert_allclose(ht[f].numpy(), np.asarray(hj[f]),
                                       rtol=HEAD_TOL, atol=HEAD_TOL)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=HEAD_TOL,
                                   atol=HEAD_TOL)
        np.testing.assert_allclose(
            float(H.accuracy(ht, _t(feats), _t(labels))),
            float(JH.accuracy(hj, feats, labels)))

    def test_adam_matches_reference_with_decoupled_decay(self):
        rng = np.random.RandomState(4)
        p0 = {"w": rng.randn(5, 3).astype(np.float32),
              "b": rng.randn(3).astype(np.float32)}
        oj = jopt.adam(1e-2, weight_decay=0.1)
        ot = optim.adam(1e-2, weight_decay=0.1)
        pj, pt = p0, {k: _t(v) for k, v in p0.items()}
        sj, st = oj.init(pj), ot.init(pt)
        for _ in range(5):
            g = {k: rng.randn(*v.shape).astype(np.float32)
                 for k, v in p0.items()}
            uj, sj = oj.update(g, sj, pj)
            pj = jopt.apply_updates(pj, uj)
            ut, st = ot.update({k: _t(v) for k, v in g.items()}, st, pt)
            pt = optim.apply_updates(pt, ut)
        for k in p0:
            np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]),
                                       rtol=1e-6, atol=1e-6)

    def test_entry_point_needs_cuda_unless_cpu_is_asked(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present")
        pi, mu, c, labels, counts = _slot_stack(0)
        with pytest.raises(RuntimeError, match="CUDA"):
            H.train_head_from_gmms(_t(pi), _t(mu), _t(c), _t(labels),
                                   _t(counts), 3, H.HeadConfig(), "diag")
