"""The slice as a whole: foundation features → per-client GMMs → bf16 wire
→ fused head, in the port and in the JAX package, on the CPU.

Draws cannot match stream for stream, so the whole pipeline is held in
law: the port's own-generator run meets the reference's bar
``acc > acc_centralized − 0.08`` (``tests/test_system.py``) on features
that both packages compute alike from the same weights, and lands within
0.08 of the reference's own FedPFT accuracy on them.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import FOUNDATION_STANDIN as J_STANDIN
from repro.core import fedpft as JFP
from repro.core import gmm as JG
from repro.core import head as JH
from repro.models import model as JM
from repro_torch import data as D
from repro_torch.core import fedpft as FP
from repro_torch.core import gmm as G
from repro_torch.core import head as H
from repro_torch.fl import api as A
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_numpy


def _frames(x, F):
    B = x.shape[0]
    return np.pad(x.reshape(B, 8, 8), ((0, 0), (0, 0), (0, F - 8)))


@pytest.fixture(scope="module")
def features():
    """Train/test features of the standin encoder (f32, carried weights)
    from both packages."""
    jcfg = dataclasses.replace(J_STANDIN, dtype="float32", n_layers=2)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(
        tcfg, jax.tree.map(lambda a: np.asarray(a, np.float32), jparams),
        device="cpu")
    dcfg = D.DatasetConfig(n_classes=4, n_per_class=60, input_dim=64,
                           class_sep=3.0)
    out = {}
    for split in (0, 1):
        x, y = D.make_dataset(dcfg, split=split)
        fr = _frames(x, tcfg.frame_embed_dim)
        out[split] = (
            M.features(tcfg, tparams, {"frames": fr}, device="cpu"),
            np.asarray(JM.features(jcfg, jparams, {"frames": fr})),
            torch.from_numpy(y))
    return out


def test_both_packages_compute_the_same_features(features):
    for split in (0, 1):
        np.testing.assert_allclose(features[split][0].numpy(),
                                   features[split][1], rtol=1e-4, atol=1e-4)


def test_port_pipeline_meets_the_reference_bar(features):
    (f, fj, y), (ft, fjt, yt) = features[0], features[1]
    parts = D.iid_shards(len(y), 3)
    cfg = FP.FedPFTConfig(
        gmm=G.GMMConfig(n_components=2, cov_type="diag", n_iter=10),
        head=H.HeadConfig(n_steps=250, lr=3e-3))
    head, info = FP.run_fedpft([(f[p], y[p]) for p in parts], 4, cfg,
                               device="cpu")
    acc = float(H.accuracy(head, ft, yt))
    head_c, _ = FP.centralized_baseline([(f[p], y[p]) for p in parts], 4, cfg,
                                        device="cpu")
    acc_c = float(H.accuracy(head_c, ft, yt))
    assert acc > acc_c - 0.08, (acc, acc_c)
    assert info["comm_bytes"] == sum(len(m.payload)
                                     for m in info["messages"])

    jcfg = JFP.FedPFTConfig(
        gmm=JG.GMMConfig(n_components=2, cov_type="diag", n_iter=10),
        head=JH.HeadConfig(n_steps=250, lr=3e-3))
    key = jax.random.PRNGKey(0)
    yn = y.numpy()
    jhead, jinfo = JFP.run_fedpft(key, [(fj[p], yn[p]) for p in parts], 4,
                                  jcfg)
    acc_j = float(JH.accuracy(jhead, fjt, yt.numpy()))
    assert abs(acc - acc_j) <= 0.08, (acc, acc_j)
    assert info["comm_bytes"] == jinfo["comm_bytes"]


def test_cohort_padding_rows_are_inert(features):
    """Clients padded with label −1 rows (``pad_client``) give the same
    counts and messages as unpadded ones."""
    f, _, y = features[0]
    feats, labels = f[:50], y[:50]
    pf, pl = FP.pad_client(feats, labels, 64)
    assert pf.shape == (64, f.shape[1]) and int((pl == -1).sum()) == 14
    sess = A.FedSession(n_classes=4, summarizer=A.GMMSummarizer(
        G.GMMConfig(n_components=2, n_iter=4)),
        head=H.HeadConfig(n_steps=5))
    a = sess.run([(feats, labels)], device="cpu")
    b = sess.run([(pf, pl)], device="cpu")
    assert a.messages[0].header.counts == b.messages[0].header.counts


def test_session_options_filter_resample_and_normalize(features):
    f, _, y = features[0]
    gmm = A.GMMSummarizer(G.GMMConfig(n_components=2, n_iter=3))
    head = H.HeadConfig(n_steps=3)
    keep = torch.cat([torch.nonzero(y != 3)[:, 0],
                      torch.nonzero(y == 3)[:5, 0]])
    small = (f[keep], y[keep])                      # class 3: 5 rows
    res = A.FedSession(n_classes=4, summarizer=gmm, head=head,
                       min_class_count=10, samples_per_class=7).run(
        [small], device="cpu")
    msg = res.messages[0]
    assert msg.header.counts[3] == 0 and msg.header.present == (0, 1, 2)
    assert msg.comm_bytes == G.comm_bytes("diag", f.shape[1], 2, 3)
    table = res.info["synthesis_plans"][0].slot_table
    assert list(table.counts) == [7, 7, 7]
    res = A.FedSession(n_classes=4, summarizer=gmm, head=head,
                       normalize_features=True).run([(f * 50, y)],
                                                    device="cpu")
    assert float(res.messages[0].params["mu"].norm(dim=-1).max()) <= 1.01


def test_unported_options_name_their_roadmap_item():
    """Mesh execution (item 9, done) runs a round on a 1-rank gloo group
    on the CPU; the gradients of ``wkv6`` and ``ssd`` (item 13, done: a
    backward kernel each on the card) are, on CPU tensors, those of the
    plain versions; the options of items 4 and 5 (ingest, the
    round-program cache, resilience) run a round on the CPU."""
    gm = torch.Generator().manual_seed(3)
    feats = torch.randn(16, 3, generator=gm)
    labels = torch.arange(16) % 2
    res = A.FedSession(n_classes=2, shards=1).run([(feats, labels)],
                                                  device="cpu")
    assert res.info["n_shards"] == 1
    assert res.info["comm_bytes"] == sum(len(m.payload)
                                         for m in res.messages)
    from repro_torch.kernels import ops, ref
    g = torch.Generator().manual_seed(0)

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=g)
    wargs = (rnd(1, 2, 12, 8), rnd(1, 2, 12, 8), rnd(1, 2, 12, 8),
             -torch.rand(1, 2, 12, 8, generator=g), rnd(2, 8), rnd(1, 2, 8, 8))
    sargs = (rnd(1, 2, 12, 8), -torch.rand(1, 2, 12, generator=g),
             rnd(1, 12, 4), rnd(1, 12, 4), rnd(1, 2, 4, 8))
    ops.reset_launch_counts()
    for fn, plain, args in ((ops.wkv6, ref.wkv6_ref, wargs),
                            (ops.ssd, ref.ssd_ref, sargs)):
        grads = []
        for f in (fn, plain):
            leaves = [a.clone().requires_grad_() for a in args]
            out, S = f(*leaves, chunk=4)
            (out.square().sum() + S.sum()).backward()
            grads.append([t.grad for t in leaves])
        for a, b in zip(*grads):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert all(v == 0 for v in ops.launch_counts().values())
    from repro_torch.fl.ingest import IngestConfig
    from repro_torch.fl.resilience import ResilienceConfig
    from repro_torch.launch.aot_cache import ProgramCache
    x, y = D.make_dataset(D.DatasetConfig(n_classes=2, n_per_class=20,
                                          input_dim=3))
    clients = [(torch.from_numpy(x), torch.from_numpy(y))]
    head = H.HeadConfig(n_steps=5, batch_size=8)
    gmm = A.GMMSummarizer(G.GMMConfig(1, "diag", n_iter=3))
    for kw in ({"ingest": IngestConfig(capacity=4)},
               {"program_cache": ProgramCache()},
               {"resilience": ResilienceConfig()}):
        res = A.FedSession(n_classes=2, summarizer=gmm, head=head,
                           **kw).run(clients, device="cpu")
        assert res.model["w"].shape == (3, 2), kw
        assert torch.isfinite(res.model["w"]).all(), kw


@pytest.mark.parametrize("option", ["dp", "pooled", "avg"])
def test_lifted_options_run_like_the_reference(features, option):
    """DP-FedPFT, pooled synthesis and head averaging run in the port on
    the standin features: the same bytes as the reference's session, and
    an accuracy within 0.08 of the reference's (pooled: also the
    reference's bar against the centralized head)."""
    from repro.core import dp as JDP
    from repro.fl import api as JA
    from repro_torch.core import dp as DP
    (f, fj, y), (ft, fjt, yt) = features[0], features[1]
    parts = D.iid_shards(len(y), 3)
    head_t, head_j = H.HeadConfig(n_steps=250, lr=3e-3), \
        JH.HeadConfig(n_steps=250, lr=3e-3)
    if option == "dp":
        kw_t = dict(dp=DP.DPConfig(epsilon=50.0), normalize_features=True,
                    summarizer=A.GMMSummarizer(G.GMMConfig(1, "full", 8)))
        kw_j = dict(dp=JDP.DPConfig(epsilon=50.0), normalize_features=True,
                    summarizer=JA.GMMSummarizer(JG.GMMConfig(1, "full", 8)))
    elif option == "pooled":
        kw_t = dict(synthesis="pooled",
                    summarizer=A.GMMSummarizer(G.GMMConfig(2, n_iter=10)))
        kw_j = dict(synthesis="pooled",
                    summarizer=JA.GMMSummarizer(JG.GMMConfig(2, n_iter=10)))
    else:
        kw_t = dict(aggregate="avg", summarizer=A.HeadSummarizer())
        kw_j = dict(aggregate="avg", summarizer=JA.HeadSummarizer())
    res = A.FedSession(n_classes=4, head=head_t, **kw_t).run(
        [(f[p], y[p]) for p in parts], device="cpu")
    yn = y.numpy()
    rj = JA.FedSession(n_classes=4, head=head_j, **kw_j).run(
        jax.random.PRNGKey(0), [(fj[p], yn[p]) for p in parts])
    assert res.info["comm_bytes"] == rj.info["comm_bytes"] == sum(
        len(m.payload) for m in res.messages)

    def normed(a):
        if not kw_t.get("normalize_features"):
            return a
        return a / np.maximum(np.linalg.norm(a, axis=-1, keepdims=True), 1.0)
    acc = float(H.accuracy(res.model, torch.from_numpy(
        normed(ft.numpy())), yt))
    acc_j = float(JH.accuracy(rj.model, normed(fjt), yt.numpy()))
    assert abs(acc - acc_j) <= 0.08, (acc, acc_j)
    if option == "pooled":
        head_c, _ = FP.centralized_baseline(
            [(f[p], y[p]) for p in parts], 4,
            FP.FedPFTConfig(head=head_t), device="cpu")
        assert acc > float(H.accuracy(head_c, ft, yt)) - 0.08


def test_entry_points_need_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    clients = [(torch.randn(8, 3), torch.zeros(8).long())]
    with pytest.raises(RuntimeError, match="CUDA"):
        A.FedSession(n_classes=2).run(clients)
    with pytest.raises(RuntimeError, match="CUDA"):
        FP.run_fedpft(clients, 2, FP.FedPFTConfig())
    from repro_torch.core import decentralized as DC
    from repro_torch.core import dp as DP
    from repro_torch.fl import baselines as B
    full = FP.FedPFTConfig(gmm=G.GMMConfig(1, "full"))
    for run in (lambda: DP.run_dp_fedpft(clients, 2, full, DP.DPConfig()),
                lambda: DC.run_chain(clients, 2, FP.FedPFTConfig()),
                lambda: FP.client_update(*clients[0], 2, FP.FedPFTConfig()),
                lambda: B.fedavg(clients, 2, B.MultiRoundConfig()),
                lambda: A.FedSession(n_classes=2, topology=A.Ring()).run(
                    clients),
                lambda: A.FedSession(n_classes=2, synthesis="pooled").run(
                    clients)):
        with pytest.raises(RuntimeError, match="CUDA"):
            run()
