"""The port's materialized synthesis, streamed head and the server's
streamed / pooled modes against ``repro/fl/api.py`` and
``repro/core/head.py``.

Draws are fed from the reference's keys (``fold_in(key, global slot id)``
per slot, then the component and Gaussian keys), so diag/spher samples
match to 1e-5 and the streamed head to 1e-4 (``tests/test_torch_head.py``'s
bar).  Full-covariance draws rotate with the eigenvector signs of the
factor, so there each draw is held to its Mahalanobis norm ‖eps‖².  The
invariants the reference proves within itself hold within the port bit
for bit: ``synthesize_batched`` is the concatenation of
``synthesize_chunks``, ``synthesize_groups`` over a homogeneous cohort is
``synthesize_batched``, and count-0 ``identity_gmm`` padding leaves the
fused head unchanged (DESIGN §11).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import head as JH
from repro.fl import api as JA
from repro_torch import data as D
from repro_torch.analysis import sanitize
from repro_torch.core import fedpft as FP
from repro_torch.core import gmm as G
from repro_torch.core import head as H
from repro_torch.fl import api as A

HEAD_TOL = 1e-4
SKEWED = np.asarray([[5, 0, 17, 1], [2, 9, 0, 33]], np.int64)


@pytest.fixture()
def port_sanitized():
    """The port's runtime sanitizer (NaN / Inf checks on every op and
    kernel output, the generator stream tracer) armed for one test; a
    deliberate same-seed rerun calls ``port_sanitized.reset()``."""
    with sanitize() as state:
        yield state


def _t(a):
    return torch.from_numpy(np.array(a))


def _batch(seed, M=2, C=4, K=3, d=6, cov="diag"):
    rng = np.random.RandomState(seed)
    pi = rng.dirichlet(np.ones(K), (M, C)).astype(np.float32)
    mu = (rng.randn(M, C, K, d) + 3 * np.eye(C, d)[None, :, None]) \
        .astype(np.float32)
    if cov == "full":
        a = rng.randn(M, C, K, d, d)
        c = a @ np.swapaxes(a, -1, -2) / d + 0.1 * np.eye(d)
    elif cov == "diag":
        c = rng.rand(M, C, K, d) + 0.1
    else:
        c = rng.rand(M, C, K) + 0.1
    return {"pi": pi, "mu": mu, "cov": c.astype(np.float32)}


def _ref_draw_fn(key, batch):
    """A bucket's draws as the reference's ``_sample_stacked`` makes them:
    ``fold_in(key, slot)``, split into the component and Gaussian keys."""
    pi = np.asarray(batch["pi"]).reshape(-1, batch["pi"].shape[-1])
    d = batch["mu"].shape[-1]

    def fn(slot_ids, S):
        comps, eps = [], []
        for s in slot_ids:
            kc, kn = jax.random.split(jax.random.fold_in(key, int(s)))
            comps.append(jax.random.categorical(
                kc, jnp.log(jnp.clip(jnp.asarray(pi[s]), 1e-20)), shape=(S,)))
            eps.append(jax.random.normal(kn, (S, d), jnp.float32))
        return {"comp": _t(jnp.stack(comps)), "eps": _t(jnp.stack(eps))}
    return fn


def _port(batch):
    return {k: _t(v) for k, v in batch.items()}


def _seeded(seed=0):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


class TestSynthesisParity:
    @pytest.mark.parametrize("cov", ["diag", "spher", "full"])
    def test_sample_stacked_with_reference_draws(self, cov):
        b = _batch(1, M=1, C=3, cov=cov)
        flat = {k: v[0] for k, v in b.items()}
        key = jax.random.PRNGKey(3)
        slots = jnp.asarray([4, 7, 9])
        exp = np.asarray(JA._sample_stacked(key, slots, flat["pi"],
                                            flat["mu"], flat["cov"], 8, cov))
        comps, eps = [], []
        for s, p in zip([4, 7, 9], flat["pi"]):
            kc, kn = jax.random.split(jax.random.fold_in(key, s))
            comps.append(jax.random.categorical(
                kc, jnp.log(jnp.clip(jnp.asarray(p), 1e-20)), shape=(8,)))
            eps.append(jax.random.normal(kn, (8, 6), jnp.float32))
        dr = {"comp": _t(jnp.stack(comps)), "eps": _t(jnp.stack(eps))}
        got = A._sample_stacked(*(_t(flat[k]) for k in G.WIRE_FIELDS), 8, cov,
                                draws=dr).numpy()
        if cov != "full":
            np.testing.assert_allclose(got, exp, rtol=1e-5, atol=1e-5)
            return
        comp = dr["comp"].numpy()
        e2 = (dr["eps"].numpy() ** 2).sum(-1)
        for x in (got, exp):
            for g in range(3):
                diff = x[g] - flat["mu"][g][comp[g]]
                sol = np.linalg.solve(flat["cov"][g][comp[g]],
                                      diff[..., None])[..., 0]
                np.testing.assert_allclose((diff * sol).sum(-1), e2[g],
                                           rtol=1e-3)

    @pytest.mark.parametrize("cov,spc", [("diag", None), ("spher", None),
                                         ("diag", 7)])
    def test_synthesize_chunks_with_reference_draws(self, cov, spc):
        b = _batch(2, cov=cov)
        key = jax.random.PRNGKey(5)
        cj, pj = JA.synthesize_chunks(key, b, SKEWED, cov, spc)
        ct, pt = A.synthesize_chunks(_port(b), SKEWED, cov, spc,
                                     draws=_ref_draw_fn(key, b))
        assert pt.padded_draws == pj.padded_draws
        assert len(ct) == len(cj)
        for (ft, yt), (fj, yj) in zip(ct, cj):
            np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
            np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-5,
                                       atol=1e-5)

    def test_synthesize_looped_with_reference_draws(self, port_sanitized):
        b = _batch(3)
        key = jax.random.PRNGKey(6)
        fj, yj = JA.synthesize_looped(key, b, SKEWED, "diag")
        ft, yt = A.synthesize_looped(_port(b), SKEWED, "diag",
                                     draws=_ref_draw_fn(key, b))
        assert port_sanitized.n_values > 0
        np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
        np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-5,
                                   atol=1e-5)

    def test_classwise_01_loss_matches_reference(self):
        rng = np.random.RandomState(4)
        head = {"w": rng.randn(5, 3).astype(np.float32),
                "b": rng.randn(3).astype(np.float32)}
        x = rng.randn(40, 5).astype(np.float32)
        y = rng.randint(0, 3, 40)
        lj, cj = JH.classwise_01_loss(head, x, y, 3)
        lt, ct = H.classwise_01_loss({k: _t(v) for k, v in head.items()},
                                     _t(x), _t(y), 3)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-6)
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))


class TestSynthesisInvariants:
    @pytest.mark.parametrize("cov", ["diag", "full"])
    def test_batched_is_the_concatenation_of_chunks(self, cov):
        b = _port(_batch(4, cov=cov))
        chunks, plan = A.synthesize_chunks(b, SKEWED, cov,
                                           generator=_seeded(1))
        f, y = A.synthesize_batched(b, SKEWED, cov, generator=_seeded(1))
        assert torch.equal(f, torch.cat([c for c, _ in chunks]))
        assert torch.equal(y, torch.cat([c for _, c in chunks]))
        assert f.shape == (int(SKEWED.sum()), 6)
        np.testing.assert_array_equal(np.bincount(y.numpy(), minlength=4),
                                      SKEWED.sum(0))
        assert plan.padded_draws <= 2 * int(SKEWED.sum())

    def test_groups_over_a_homogeneous_cohort_are_batched(self):
        b = _port(_batch(5))
        items = [({k: v[m] for k, v in b.items()}, SKEWED[m], "diag")
                 for m in range(2)]
        fg, yg = A.synthesize_groups(items, generator=_seeded(2))
        fb, yb = A.synthesize_batched(b, SKEWED, "diag",
                                      generator=_seeded(2))
        assert torch.equal(fg, fb) and torch.equal(yg, yb)

    def test_heterogeneous_cohort_gets_one_plan_per_family(self):
        diag = _port(_batch(6, M=1, K=2))
        full = _port(_batch(7, M=1, K=1, cov="full"))
        items = [({k: v[0] for k, v in diag.items()}, SKEWED[0], "diag"),
                 ({k: v[0] for k, v in full.items()}, SKEWED[1], "full")]
        chunks, plans = A.synthesize_group_chunks(items,
                                                  generator=_seeded(3))
        assert len(plans) == 2
        y = torch.cat([c for _, c in chunks])
        np.testing.assert_array_equal(np.bincount(y.numpy(), minlength=4),
                                      SKEWED.sum(0))

    def test_empty_counts_and_mesh(self):
        b = _port(_batch(8, M=1))
        f, y = A.synthesize_batched({k: v[0] for k, v in b.items()},
                                    np.zeros(4), "diag",
                                    generator=_seeded())
        assert f.shape == (0, 6) and y.shape == (0,)
        # a mesh (one gloo rank): each bucket's rows transformed by the
        # ranks and gathered are the chunks of a run without it, bitwise
        from repro_torch.launch.mesh import make_sim_mesh
        plain, _ = A.synthesize_chunks(b, SKEWED[:1], "diag",
                                       generator=_seeded(2))
        meshed, _ = A.synthesize_chunks(b, SKEWED[:1], "diag",
                                        mesh=make_sim_mesh(1, device="cpu"),
                                        generator=_seeded(2))
        assert len(plain) == len(meshed)
        for (fp, yp), (fm, ym) in zip(plain, meshed):
            assert torch.equal(fp, fm) and torch.equal(yp, ym)

    @pytest.mark.parametrize("cov", ["full", "diag"])
    def test_identity_padding_leaves_the_fused_head_bit_identical(self, cov):
        """A prefix of count-0 ``identity_gmm`` rows is never drawn: the
        head and its losses are the unpadded stack's, bit for bit."""
        b = _port(_batch(9, cov=cov))
        stack, labels, counts, _ = A.fused_slot_stack(b, SKEWED)
        cfg = H.HeadConfig(n_steps=40, batch_size=32, noise_window=16)
        base, bl = H.train_head_from_gmms(
            stack["pi"], stack["mu"], stack["cov"], labels, counts, 4, cfg,
            cov, device="cpu", generator=_seeded(4))
        pad = G.identity_gmm(3, 6, cov)
        n_pad = 3

        def grow(a, p):
            p = torch.from_numpy(p)[None]
            return torch.cat([p.expand((n_pad,) + p.shape[1:]), a])
        padded, pl = H.train_head_from_gmms(
            *(grow(stack[k], pad[k]) for k in G.WIRE_FIELDS),
            torch.cat([torch.zeros(n_pad, dtype=labels.dtype), labels]),
            torch.cat([torch.zeros(n_pad, dtype=counts.dtype), counts]),
            4, cfg, cov, device="cpu", generator=_seeded(4))
        for k in ("w", "b"):
            assert torch.equal(base[k], padded[k])
        assert torch.equal(bl, pl)


def _reference_streaming_idx(key, chunks, cfg):
    """Step t's minibatch rows as ``repro.core.head.train_head_streaming``
    draws them from ``key`` (allocation order)."""
    _, _, k_steps = jax.random.split(key, 3)
    sizes = np.asarray([len(y) for _, y in chunks], np.float64)
    raw = sizes / sizes.sum() * cfg.n_steps
    n_per = np.floor(raw).astype(np.int64)
    short = cfg.n_steps - int(n_per.sum())
    if short:
        n_per[np.argsort(-(raw - np.floor(raw)))[:short]] += 1
    owner = np.repeat(np.arange(len(chunks)), n_per)
    keys = jax.random.split(k_steps, cfg.n_steps)
    return _t(jnp.stack([
        jax.random.randint(k, (cfg.batch_size,), 0, int(sizes[j]))
        for k, j in zip(keys, owner)]))


def test_train_head_streaming_with_reference_draws():
    rng = np.random.RandomState(10)
    chunks = [(rng.randn(n, 6).astype(np.float32) + 2 * (n % 3),
               np.full((n,), n % 3, np.int32)) for n in (5, 40, 90)]
    chunks.append((np.zeros((0, 6), np.float32), np.zeros((0,), np.int32)))
    cfg_j = JH.HeadConfig(n_steps=37, batch_size=16, lr=3e-3)
    cfg_t = H.HeadConfig(n_steps=37, batch_size=16, lr=3e-3)
    key = jax.random.PRNGKey(8)
    hj, lj = JH.train_head_streaming(key, chunks, 3, cfg_j)
    k_init = jax.random.split(key, 3)[0]
    draws = {"init": _t(jax.random.normal(k_init, (6, 3), jnp.float32)),
             "idx": _reference_streaming_idx(key, chunks[:3], cfg_j)}
    ht, lt = H.train_head_streaming([(_t(f), _t(y)) for f, y in chunks], 3,
                                    cfg_t, draws=draws)
    for f in ("w", "b"):
        np.testing.assert_allclose(ht[f].numpy(), np.asarray(hj[f]),
                                   rtol=HEAD_TOL, atol=HEAD_TOL)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=HEAD_TOL,
                               atol=HEAD_TOL)
    empty, losses = H.train_head_streaming(
        [(torch.zeros(0, 6), torch.zeros(0).long())], 3, cfg_t,
        generator=_seeded())
    assert losses.shape == (0,) and torch.all(empty["b"] == 0)


@pytest.fixture(scope="module")
def clients():
    dcfg = D.DatasetConfig(n_classes=4, n_per_class=80, input_dim=10,
                           class_sep=3.0)
    x, y = D.make_dataset(dcfg)
    xt, yt = D.make_dataset(dcfg, split=1)
    parts = D.iid_shards(len(y), 3)
    return ([(torch.from_numpy(x[p]), torch.from_numpy(y[p]))
             for p in parts], torch.from_numpy(xt), torch.from_numpy(yt))


@pytest.mark.parametrize("mode", ["streamed", "pooled"])
def test_server_modes_meet_the_centralized_bar(clients, mode):
    data, xt, yt = clients
    cfg = FP.FedPFTConfig(gmm=G.GMMConfig(2, "diag", n_iter=8),
                          head=H.HeadConfig(n_steps=200, lr=3e-3))
    fused = FP.session_for(4, cfg).run(data, device="cpu")
    res = FP.session_for(4, cfg, synthesis=mode).run(data, device="cpu")
    head_c, _ = FP.centralized_baseline(data, 4, cfg, device="cpu")
    acc = float(H.accuracy(res.model, xt, yt))
    assert acc > float(H.accuracy(head_c, xt, yt)) - 0.08
    assert res.info["synthesis"] == mode
    assert res.info["comm_bytes"] == fused.info["comm_bytes"] == sum(
        len(m.payload) for m in res.messages)
    n = sum(len(y) for _, y in data)
    if mode == "pooled":
        assert res.info["synthetic_feats"].shape == (n, 10)
    else:
        assert sum(len(y) for _, y in res.info["synthetic_chunks"]) == n
    with pytest.raises(ValueError, match="unknown synthesis"):
        FP.session_for(4, cfg, synthesis="bogus").run(data, device="cpu")


def test_heterogeneous_cohort_falls_back_to_pooled(clients):
    data, xt, yt = clients
    cfg = FP.FedPFTConfig(gmm=G.GMMConfig(2, "diag", n_iter=6),
                          head=H.HeadConfig(n_steps=150, lr=3e-3))
    mixed = [cfg, FP.FedPFTConfig(gmm=G.GMMConfig(1, "full", n_iter=4)),
             FP.FedPFTConfig(gmm=G.GMMConfig(3, "spher", n_iter=4))]
    head, info = FP.run_fedpft(data, 4, cfg, mixed, device="cpu")
    assert info["synthesis"] == "pooled"
    assert info["synthesis_fallback"] == "heterogeneous cohort"
    assert [m.header.cov_type for m in info["messages"]] == \
        ["diag", "full", "spher"]
    assert info["comm_bytes"] == sum(len(m.payload)
                                     for m in info["messages"])
    assert float(H.accuracy(head, xt, yt)) > 0.8
