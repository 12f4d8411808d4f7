"""The port's baselines (``fl/baselines.py``), head summaries and the rest of
``optim`` against the JAX package.

Heads are held at 1e-4 with the reference's draws injected (minibatch
indices, head init, FedBE's posterior noise); the optimizers per step at
1e-6 (``tests/test_torch_head.py``'s Adam bar); the head wire byte for
byte.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.fl import api as JA
from repro.fl import baselines as JB
from repro_torch import data as D
from repro_torch import optim
from repro_torch.core import head as H
from repro_torch.fl import api as A
from repro_torch.fl import baselines as B

HEAD_TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _tt(tree):
    return {k: _t(v) for k, v in tree.items()}


def _close(got, exp, tol=HEAD_TOL):
    for k in exp:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(exp[k]),
                                   rtol=tol, atol=tol)


def _steps_idx(key, n_steps, bs, N):
    return _t(jnp.stack([jax.random.randint(k, (bs,), 0, N)
                         for k in jax.random.split(key, n_steps)]))


def _data(seed=0, N=60, d=6, C=3):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, C, N).astype(np.int32)
    x = (rng.randn(N, d) + 2.0 * np.eye(C, d)[y]).astype(np.float32)
    return x, y


def _head(seed, d=6, C=3):
    rng = np.random.RandomState(seed)
    return {"w": (0.1 * rng.randn(d, C)).astype(np.float32),
            "b": (0.1 * rng.randn(C)).astype(np.float32)}


class TestOptim:
    @pytest.mark.parametrize("name,kw", [
        ("sgd", {"momentum": 0.0}), ("sgd", {"momentum": 0.9}),
        ("sgd", {"momentum": 0.9, "nesterov": True}), ("yogi", {}),
        ("adam", {"sched": True})])
    def test_matches_reference_per_step(self, name, kw):
        rng = np.random.RandomState(4)
        p0 = _head(1)
        sched = kw.pop("sched", False)
        lr_j = jopt.cosine_schedule(1e-2, 5, warmup_steps=2) if sched \
            else 1e-2
        lr_t = optim.cosine_schedule(1e-2, 5, warmup_steps=2) if sched \
            else 1e-2
        oj = getattr(jopt, name)(lr_j, **kw)
        ot = getattr(optim, name)(lr_t, **kw)
        pj, pt = p0, _tt(p0)
        sj, st = oj.init(pj), ot.init(pt)
        for _ in range(5):
            g = {k: rng.randn(*v.shape).astype(np.float32)
                 for k, v in p0.items()}
            uj, sj = oj.update(g, sj, pj)
            pj = jopt.apply_updates(pj, uj)
            ut, st = ot.update(_tt(g), st, pt)
            pt = optim.apply_updates(pt, ut)
        _close(pt, pj, 1e-6)

    @pytest.mark.parametrize("kind", ["cosine", "linear"])
    def test_schedules_match_reference(self, kind):
        fj = getattr(jopt, f"{kind}_schedule")(3e-3, 20, warmup_steps=4)
        ft = getattr(optim, f"{kind}_schedule")(3e-3, 20, warmup_steps=4)
        for step in range(25):
            np.testing.assert_allclose(ft(step), float(fj(step)), rtol=1e-6)


class TestOneShot:
    @pytest.mark.parametrize("prox", [0.0, 0.5])
    def test_local_train_with_reference_draws(self, prox):
        x, y = _data()
        h0 = _head(2)
        key = jax.random.PRNGKey(1)
        hj = JB.local_train(key, h0, x, y, 3, n_steps=25, batch_size=16,
                            lr=1e-2, prox=prox)
        ht = B.local_train(_tt(h0), _t(x), _t(y), 3, n_steps=25,
                           batch_size=16, lr=1e-2, prox=prox,
                           idx=_steps_idx(key, 25, 16, 60))
        _close(ht, hj)

    def test_avg_ensemble_fedbe_with_reference_draws(self):
        heads = [_head(s) for s in range(3)]
        x, _ = _data(1)
        _close(B.avg_heads([_tt(h) for h in heads], [1.0, 2.0, 3.0]),
               JB.avg_heads(heads, [1.0, 2.0, 3.0]), 1e-6)
        np.testing.assert_array_equal(
            B.ensemble_predict([_tt(h) for h in heads], _t(x)).numpy(),
            np.asarray(JB.ensemble_predict(heads, x)))
        key = jax.random.PRNGKey(3)
        fj = JB.fedbe(key, heads, n_samples=4)
        eps = []
        for k in jax.random.split(key, 4):
            kb, kw = jax.random.split(k, 2)        # leaves in key order b, w
            eps.append({"b": _t(jax.random.normal(kb, (3,), jnp.float32)),
                        "w": _t(jax.random.normal(kw, (6, 3), jnp.float32))})
        ft = B.fedbe([_tt(h) for h in heads], n_samples=4, eps=eps)
        assert len(ft) == len(fj) == 7
        for a, b in zip(ft, fj):
            _close(a, b, 1e-6)

    def test_kd_transfer_with_reference_draws(self):
        x, y = _data(2)
        key = jax.random.PRNGKey(4)
        hj = JB.kd_transfer(key, _head(5), _head(6), jnp.asarray(x),
                            jnp.asarray(y), 3, n_steps=20)
        ht = B.kd_transfer(_tt(_head(5)), _tt(_head(6)), _t(x), _t(y), 3,
                           n_steps=20, idx=_steps_idx(key, 20, 60, 60))
        _close(ht, hj)

    def test_head_summarizer_with_reference_draws(self):
        x, y = _data(3)
        y = y.copy()
        y[-4:] = -1                            # padding rows are dropped
        key = jax.random.PRNGKey(5)
        hj, cj, _ = JA.HeadSummarizer(n_steps=30).summarize(key, x, y, 3)
        k_init, k_train = jax.random.split(key)
        draws = {"init": _t(jax.random.normal(k_init, (6, 3), jnp.float32)),
                 "idx": _steps_idx(k_train, 30, 56, 56)}
        ht, ct, _ = A.HeadSummarizer(n_steps=30).summarize(
            _t(x), _t(y).long(), 3, draws=draws)
        _close(ht, hj)
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))


class TestMultiRound:
    def test_sparsify_matches_reference(self):
        delta = _head(7)
        _close(B._sparsify(_tt(delta), 0.2), JB._sparsify(delta, 0.2), 0.0)

    @pytest.mark.parametrize("kw", [{}, {"server": "yogi"}, {"prox": 0.1},
                                    {"topk_frac": 0.25}])
    def test_fedavg_with_reference_draws(self, kw):
        clients = [_data(s, N=n) for s, n in ((10, 40), (11, 70))]
        cfg_j = JB.MultiRoundConfig(rounds=3, local_steps=6, **kw)
        cfg_t = B.MultiRoundConfig(rounds=3, local_steps=6, **kw)
        key = jax.random.PRNGKey(6)
        hj, ij = JB.fedavg(key, clients, 3, cfg_j)
        k_init, k_rounds = jax.random.split(key)
        idx = [[_steps_idx(k, 6, len(y), len(y)) for k, (_, y) in
                zip(jax.random.split(rk, 2), clients)]
               for rk in jax.random.split(k_rounds, 3)]
        draws = {"init": _t(jax.random.normal(k_init, (6, 3), jnp.float32)),
                 "idx": idx}
        ht, it = B.fedavg([(_t(x), _t(y)) for x, y in clients], 3, cfg_t,
                          device="cpu", draws=draws)
        _close(ht, hj)
        assert it == ij
        assert B.head_comm_bytes(1280, 10) == JB.head_comm_bytes(1280, 10)


@pytest.fixture(scope="module")
def cohort():
    dcfg = D.DatasetConfig(n_classes=4, n_per_class=60, input_dim=8,
                           class_sep=3.0)
    x, y = D.make_dataset(dcfg)
    xt, yt = D.make_dataset(dcfg, split=1)
    return ([(torch.from_numpy(x[p]), torch.from_numpy(y[p]))
             for p in D.iid_shards(len(y), 3)],
            torch.from_numpy(xt), torch.from_numpy(yt))


@pytest.mark.parametrize("aggregate", ["avg", "ensemble", "fedbe"])
def test_head_sessions_ship_heads(cohort, aggregate):
    data, xt, yt = cohort
    res = A.FedSession(n_classes=4, summarizer=A.HeadSummarizer(n_steps=60),
                       aggregate=aggregate).run(data, device="cpu")
    assert res.info["comm_bytes"] == sum(len(m.payload)
                                         for m in res.messages) \
        == 3 * B.head_comm_bytes(8, 4)
    heads = [res.model] if aggregate == "avg" else res.model
    assert len(heads) == {"avg": 1, "ensemble": 3, "fedbe": 13}[aggregate]
    pred = B.ensemble_predict(heads, xt)
    assert float((pred == yt).float().mean()) > 0.8
    with pytest.raises(NotImplementedError, match="GMM summarizer"):
        A.FedSession(n_classes=4, summarizer=A.HeadSummarizer(),
                     topology=A.Chain()).run(data, device="cpu")


def test_fedavg_needs_cuda_unless_cpu_is_asked(cohort):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        B.fedavg(cohort[0], 4, B.MultiRoundConfig())
