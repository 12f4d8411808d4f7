"""The port's decentralized FedPFT (``Chain`` / ``Ring`` topologies,
``FedSession.chain_step``, ``core/decentralized.py``) against the JAX
package.

One chain step is held with the reference's draws injected (the draws
from the received message per global slot, the k-means seeds of the
re-fit, the local head's init and minibatches) over an f32 wire, so no
bf16 rounding boundary separates the two: the decoded message to 2e-3
(the fit tolerance of ``tests/test_gmm.py``) and the local head to 2e-3.
Whole chains are held in law: knowledge accumulates along the chain as
in ``tests/test_decentralized_dp_theory.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fedpft as JFP
from repro.core import gmm as JG
from repro.core import head as JH
from repro.fl import api as JA
from repro_torch import data as D
from repro_torch.core import decentralized as DC
from repro_torch.core import fedpft as FP
from repro_torch.core import gmm as G
from repro_torch.core import head as H
from repro_torch.fl import api as A
from test_torch_gmm import _reference_kmeans_draws
from test_torch_synthesis import _ref_draw_fn

CHAIN_TOL = 2e-3
C, DIM = 4, 6


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def data():
    dcfg = D.DatasetConfig(n_classes=C, n_per_class=60, input_dim=DIM,
                           class_sep=3.0)
    x, y = D.make_dataset(dcfg)
    xt, yt = D.make_dataset(dcfg, split=1)
    return x, y, xt, yt


def _cfgs(n_steps=60):
    kw = dict(bytes_per_scalar=4)
    return (JFP.FedPFTConfig(gmm=JG.GMMConfig(2, "diag", n_iter=6),
                             head=JH.HeadConfig(n_steps=n_steps, lr=3e-3),
                             **kw),
            FP.FedPFTConfig(gmm=G.GMMConfig(2, "diag", n_iter=6),
                            head=H.HeadConfig(n_steps=n_steps, lr=3e-3),
                            **kw))


def test_chain_step_with_reference_draws(data):
    x, y, _, _ = data
    a, b = np.arange(0, 100), np.arange(100, 240)
    cfg_j, cfg_t = _cfgs()
    sj = JFP.session_for(C, cfg_j)
    key0, key1 = jax.random.split(jax.random.PRNGKey(2))
    received, _ = sj.chain_step(key0, x[a], y[a], 0, None)
    mj, ij = sj.chain_step(key1, x[b], y[b], 1, received)

    k_sample, k_fit, k_head = jax.random.split(key1, 3)
    syn_f, syn_y = JA.synthesize_batched(
        k_sample, received.params, received.counts, "diag")
    uy = np.concatenate([y[b], np.asarray(syn_y)])
    n = len(uy)
    idx, jit = _reference_kmeans_draws(
        k_fit, np.asarray(jax.nn.one_hot(uy, C)).T, C, 2, DIM)
    k_init, k_steps = jax.random.split(k_head)
    head_idx = jax.vmap(lambda k: jax.random.randint(k, (min(256, n),), 0,
                                                     n))(
        jax.random.split(k_steps, cfg_j.head.n_steps))
    draws = {"synthesis": _ref_draw_fn(k_sample, received.params),
             "fit": {"init_idx": idx, "jitter": jit},
             "head": {"init": _t(jax.random.normal(k_init, (DIM, C),
                                                   jnp.float32)),
                      "idx": _t(head_idx)}}
    st = FP.session_for(C, cfg_t)
    rec_t = A.encode_message({k: _t(v) for k, v in received.params.items()},
                             received.counts, received.logliks, kind="gmm",
                             cov_type="diag", n_classes=C, codec=st.codec)
    assert rec_t.payload == received.payload
    mt, it = st.chain_step(_t(x[b]), _t(y[b]), 1, rec_t,
                           device=torch.device("cpu"), draws=draws)
    assert it["n_train"] == ij["n_train"] == n
    assert mt.header.counts == mj.header.counts
    for f in G.WIRE_FIELDS:
        np.testing.assert_allclose(mt.params[f].numpy(),
                                   np.asarray(mj.params[f]),
                                   rtol=CHAIN_TOL, atol=CHAIN_TOL)
    np.testing.assert_allclose(mt.logliks, mj.logliks, rtol=CHAIN_TOL,
                               atol=CHAIN_TOL)
    for f in ("w", "b"):
        np.testing.assert_allclose(it["head"][f].numpy(),
                                   np.asarray(ij["head"][f]),
                                   rtol=CHAIN_TOL, atol=CHAIN_TOL)


def test_chain_accumulates_knowledge(data):
    """Disjoint label slices: late clients know early labels only through
    the passed GMMs, so accuracy grows along the chain (Figure 6)."""
    x, y, xt, yt = data
    _, cfg = _cfgs(n_steps=200)
    clients = [(_t(x[y == c]), _t(y[y == c])) for c in range(C)]
    msgs, infos = DC.run_chain(clients, C, cfg, device="cpu")
    accs = [float(H.accuracy(i["head"], _t(xt), _t(yt))) for i in infos]
    assert accs[-1] > accs[0] + 0.3 and accs[-1] > 0.75, accs
    assert int((msgs[-1].counts > 0).sum()) == C
    assert [i["n_train"] for i in infos] == [60, 120, 180, 240]


def test_ring_laps_and_bytes(data):
    x, y, xt, yt = data
    parts = D.iid_shards(len(y), 3)
    sess = A.FedSession(n_classes=C, topology=A.Ring(laps=2),
                        summarizer=A.GMMSummarizer(G.GMMConfig(2, n_iter=5)),
                        head=H.HeadConfig(n_steps=100, lr=3e-3))
    res = sess.run([(_t(x[p]), _t(y[p])) for p in parts], device="cpu")
    assert len(res.messages) == 6 and len(res.info["per_client"]) == 6
    assert res.info["comm_bytes"] == sum(len(m.payload)
                                         for m in res.messages)
    assert res.model is res.info["per_client"][-1]["head"]
    assert float(H.accuracy(res.model, _t(xt), _t(yt))) > 0.9
    # the v1 helpers: one step from a raw (unencoded) message
    g = torch.Generator()
    g.manual_seed(0)
    _, cfg = _cfgs()
    v1 = FP.client_update(_t(x[parts[0]]), _t(y[parts[0]]), C, cfg,
                          generator=g, device="cpu")
    msg, info = DC.chain_step(_t(x[parts[1]]), _t(y[parts[1]]), C, v1, cfg,
                              generator=g, device="cpu")
    assert info["n_train"] == len(parts[0]) + len(parts[1])
    assert msg.comm_bytes == len(msg.payload)


def test_run_chain_needs_cuda_unless_cpu_is_asked(data):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    x, y, _, _ = data
    with pytest.raises(RuntimeError, match="CUDA"):
        DC.run_chain([(_t(x), _t(y))], C, FP.FedPFTConfig())
