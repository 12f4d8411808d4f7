"""The port's ``core/distributed.py`` and ``FedSession``'s mesh execution
against ``repro/core/distributed.py`` and ``repro/fl/api.py``, on one
in-process gloo rank (the 2- and 4-rank lane is
``tests/test_torch_mesh_lane.py``).

The transfer is fed the reference's k-means draws and held at the
full-fit tolerance 2e-3 (``tests/test_torch_gmm.py``); the wire that the
mesh decodes re-encodes byte for byte as the reference's does; the
actionable errors are those of ``tests/test_distributed.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import data as JD
from repro.core import distributed as JDF
from repro.core import gmm as JG
from repro.fl import api as JA
from repro.launch.mesh import make_sim_mesh as jax_sim_mesh
from repro_torch.core import distributed as DF
from repro_torch.core import dp as DP
from repro_torch.core import gmm as G
from repro_torch.core import head as H
from repro_torch.fl import api as A
from repro_torch.launch import mesh as LM
from test_torch_gmm import FIT_TOL, _reference_kmeans_draws

C, K, I, N, DIM = 4, 2, 2, 120, 8


@pytest.fixture(scope="module")
def cohort():
    dcfg = JD.DatasetConfig(n_classes=C, n_per_class=60, input_dim=DIM)
    x, y = JD.make_dataset(dcfg)
    return (np.asarray(x[: I * N]).reshape(I, N, DIM),
            np.asarray(y[: I * N]).reshape(I, N).astype(np.int32))


@pytest.fixture(scope="module")
def mesh():
    return LM.make_sim_mesh(1, device="cpu")


def _ref_draws(labels, seed):
    """The reference's k-means draws of client i: key PRNGKey(seed + i)."""
    draws = [_reference_kmeans_draws(
        jax.random.PRNGKey(seed + i),
        np.asarray(jax.nn.one_hot(labels[i], C)).T, C, K, DIM)
        for i in range(labels.shape[0])]
    return (torch.stack([d[0] for d in draws]),
            torch.stack([d[1] for d in draws]))


def _torch_bf16(a) -> torch.Tensor:
    """A JAX bf16 array as a torch bf16 tensor, bit for bit."""
    return torch.from_numpy(np.asarray(a).view(np.int16).copy()).view(
        torch.bfloat16)


@pytest.mark.parametrize("cov", ["diag", "spher"])
def test_transfer_matches_reference_with_its_draws(cohort, mesh, cov):
    feats, labels = cohort
    seed = 3
    cfg_j = JG.GMMConfig(n_components=K, cov_type=cov, n_iter=8)
    mesh_j = jax_sim_mesh(1)
    with mesh_j:
        wire_j, counts_j, lls_j = JDF.fedpft_transfer(
            mesh_j, jnp.asarray(feats), jnp.asarray(labels), C, cfg_j,
            seed=seed)
    idx, jit = _ref_draws(labels, seed)
    with DF.record_collectives() as tally:
        wire, counts, lls = DF.fedpft_transfer(
            mesh, torch.from_numpy(feats), torch.from_numpy(labels), C,
            G.GMMConfig(n_components=K, cov_type=cov, n_iter=8), seed=seed,
            init_idx=idx, jitter=jit)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(counts_j))
    np.testing.assert_allclose(lls.numpy(), np.asarray(lls_j), rtol=FIT_TOL,
                               atol=FIT_TOL)
    got = G.unpack_wire(wire, cov, DIM)
    want = JG.unpack_wire(wire_j, cov, DIM)
    for f in JG.WIRE_FIELDS:
        assert wire[f].dtype == torch.bfloat16
        np.testing.assert_allclose(got[f].numpy(), np.asarray(want[f]),
                                   rtol=FIT_TOL, atol=FIT_TOL)
    expected = DF.expected_wire_bytes(cov, DIM, K, C, I)
    assert expected == JDF.expected_wire_bytes(cov, DIM, K, C, I)
    assert tally["by_tag"]["wire"] == expected == sum(
        np.asarray(v).nbytes for v in wire_j.values())
    assert tally["all-gather"] == expected + 2 * I * C * 4


def test_transfer_is_each_clients_own_fit(cohort, mesh):
    """With its own draws, client i's part of the wire is the fit a host
    client makes from a generator seeded ``seed`` + i."""
    feats, labels = cohort
    cfg = G.GMMConfig(n_components=K, cov_type="diag", n_iter=6)
    f, y = torch.from_numpy(feats), torch.from_numpy(labels)
    wire, counts, lls = DF.fedpft_transfer(mesh, f, y, C, cfg, seed=5)
    for i in range(I):
        g = torch.Generator().manual_seed(5 + i)
        gm, cnt, ll = G.fit_classwise_gmms(f[i], y[i], C, cfg, device="cpu",
                                           generator=g)
        packed = G.pack_wire(gm, "diag")
        for k in G.WIRE_FIELDS:
            torch.testing.assert_close(wire[k][i].float(),
                                       packed[k].float(), rtol=0, atol=0)
        np.testing.assert_array_equal(counts[i].numpy(), cnt.numpy())
        torch.testing.assert_close(lls[i], ll, rtol=1e-6, atol=1e-6)


def test_client_seeds_match_reference():
    for shard, I_local, seed in ((0, 4, 7), (2, 4, 7), (1, 3, 0)):
        np.testing.assert_array_equal(
            DF.client_seeds(shard, I_local, seed),
            np.asarray(JDF.client_seeds(shard, I_local, seed)))
    flat = np.concatenate([DF.client_seeds(s, 4, 7) for s in range(3)])
    np.testing.assert_array_equal(flat, np.arange(12, dtype=np.uint32) + 7)


@pytest.fixture(scope="module")
def reference_messages():
    """Three reference clients' full-covariance messages and session."""
    dcfg = JD.DatasetConfig(n_classes=C, n_per_class=30, input_dim=DIM)
    x, y = JD.make_dataset(dcfg)
    sess = JA.FedSession(n_classes=C, summarizer=JA.GMMSummarizer(
        JG.GMMConfig(n_components=K, cov_type="full", n_iter=4)))
    return sess, [sess.client_update(k, x, y)
                  for k in jax.random.split(jax.random.PRNGKey(0), 3)]


@pytest.mark.parametrize("validate", [False, True])
def test_messages_from_wire_matches_reference_bytes(reference_messages,
                                                    validate):
    """The reference's wire (full covariance, tril-packed), one client's
    poisoned with NaN when validating, decodes into byte-identical
    payloads and the same quarantine on both sides."""
    sess, msgs = reference_messages
    wire_j = jax.tree.map(lambda *xs: jnp.stack(xs),
                          *[JG.pack_wire(m.params, "full") for m in msgs])
    if validate:
        wire_j["mu"] = wire_j["mu"].at[1, 0, 0, 0].set(jnp.nan)
    counts = np.stack([m.counts for m in msgs])
    lls = np.stack([np.asarray(m.logliks, np.float32) for m in msgs])
    want = JA.messages_from_wire(wire_j, counts, "full", C, sess.codec,
                                 logliks=lls, validate=validate)
    got = A.messages_from_wire({k: _torch_bf16(v) for k, v in wire_j.items()},
                               counts, "full", C, A.QuantizedCodec(),
                               logliks=lls, validate=validate)
    if validate:
        (want, want_rej), (got, got_rej) = want, got
        assert [dataclasses.asdict(r) for r in got_rej] == \
            [dataclasses.asdict(r) for r in want_rej]
        assert len(got_rej) == 1 and got_rej[0].client_id == 1
    assert len(got) == len(want)
    for g_m, w_m in zip(got, want):
        assert g_m.payload == w_m.payload
        assert g_m.comm_bytes == w_m.comm_bytes
        assert g_m.header.counts == w_m.header.counts
        np.testing.assert_allclose(g_m.logliks, w_m.logliks)


class FakeDataMesh:
    """Shape-only stand-in: the checks fire before any collective."""
    axis_names = ("data",)
    shape = {"data": 3}


def test_uneven_cohort_fails_fast():
    cfg = G.GMMConfig(n_components=2, n_iter=2)
    with pytest.raises(ValueError, match="does not shard evenly"):
        DF.fedpft_transfer(FakeDataMesh(), torch.zeros(4, 8, 4),
                           torch.zeros(4, 8, dtype=torch.long), 2, cfg)
    with pytest.raises(ValueError) as e:
        DF.validate_cohort(10, 4)
    assert "I=10" in str(e.value) and "4-way" in str(e.value)
    assert "[1, 2, 5, 10]" in str(e.value)
    with pytest.raises(ValueError) as ej:
        JDF.validate_cohort(10, 4)
    assert str(e.value) == str(ej.value)
    DF.validate_cohort(10, 5)


def test_mesh_without_data_axis_fails_fast():
    class ModelOnlyMesh:
        axis_names = ("model",)
        shape = {"model": 2}
    with pytest.raises(ValueError, match="'data' axis"):
        DF.fedpft_transfer(ModelOnlyMesh(), torch.zeros(2, 4, 2),
                           torch.zeros(2, 4, dtype=torch.long), 2,
                           G.GMMConfig(n_components=1, n_iter=1))


def test_client_axis_mismatch_fails_fast():
    with pytest.raises(ValueError, match="client axis"):
        DF.fedpft_transfer(FakeDataMesh(), torch.zeros(3, 4, 2),
                           torch.zeros(2, 4, dtype=torch.long), 2,
                           G.GMMConfig(n_components=1, n_iter=1))


def test_make_sim_mesh_is_actionable_when_ranks_missing(mesh):
    """With one rank, a 2- or 7-way mesh names the launch that gives it
    the ranks, as one unbroken token."""
    for n in (2, 7):
        with pytest.raises(ValueError) as ei:
            LM.make_sim_mesh(n, device="cpu")
        assert f"torchrun --nproc-per-node={n}" in str(ei.value)
    assert LM.axes_of(LM.make_sim_mesh(1, device="cpu")) == {"data": 1}
    with pytest.raises(ValueError, match="n >= 1"):
        LM.make_sim_mesh(0)


def test_meshes_and_constants():
    single = LM.make_production_mesh()
    multi = LM.make_production_mesh(multi_pod=True)
    assert LM.axes_of(single) == {"data": 16, "model": 16}
    assert LM.axes_of(multi) == {"pod": 2, "data": 16, "model": 16}
    assert LM.data_axes(multi) == ("pod", "data")
    assert LM.axis_size(single, "pod") == 1
    assert (LM.PEAK_FLOPS_BF16, LM.PEAK_FLOPS_F32, LM.HBM_BW,
            LM.NVLINK_BW) == (989e12, 67e12, 3.35e12, 450e9)
    assert LM.axes_of(LM.make_host_mesh(device="cpu")) == {"data": 1,
                                                           "model": 1}


def test_raw_transfer_roundtrip(mesh):
    g = torch.Generator().manual_seed(0)
    feats = torch.randn(2, 16, 8, generator=g)
    labels = torch.randint(0, 4, (2, 16), generator=g)
    with DF.record_collectives() as tally:
        f, y = DF.raw_feature_transfer(mesh, feats, labels)
    assert f.dtype == torch.bfloat16 and y.dtype == torch.int32
    torch.testing.assert_close(f.float(), feats, rtol=1e-2, atol=1e-2)
    assert torch.equal(y.long(), labels)
    assert tally["all-gather"] == 2 * 16 * 8 * 2 + 2 * 16 * 4


def _session(**kw):
    return A.FedSession(n_classes=C, summarizer=A.GMMSummarizer(
        G.GMMConfig(n_components=K, cov_type="diag", n_iter=5)),
        head=H.HeadConfig(n_steps=30, lr=3e-3), **kw)


def test_run_sharded_is_run_with_one_shard(cohort, mesh):
    """run() with shards=1 stacks the clients and runs the mesh path —
    bitwise run_sharded; mesh= gives the same round."""
    feats, labels = cohort
    f, y = torch.from_numpy(feats), torch.from_numpy(labels)
    direct = _session(shards=1).run_sharded(f, y, seed=2, device="cpu")
    via_run = _session(shards=1).run([(f[i], y[i]) for i in range(I)],
                                     seed=2, device="cpu")
    via_mesh = _session(mesh=mesh).run_sharded(f, y, seed=2, device="cpu")
    for p in ("w", "b"):
        assert torch.equal(direct.model[p], via_run.model[p])
        assert torch.equal(direct.model[p], via_mesh.model[p])
    info = direct.info
    assert info["n_shards"] == 1 and info["mesh_axes"] == ("data",)
    assert info["comm_bytes"] == sum(len(m.payload)
                                     for m in direct.messages)
    assert info["mesh_wire_bytes"] == DF.expected_wire_bytes("diag", DIM, K,
                                                             C, I)
    assert set(info["phase_s"]) == {"client_fit_s", "encode_s", "server_s"}


@pytest.mark.parametrize("synthesis", ["fused", "streamed"])
def test_run_sharded_is_the_host_star_round_on_the_same_draws(cohort,
                                                              synthesis):
    """The mesh round equals the host path fed the same draws: each
    client's fit from a generator seeded ``transfer_seed + i``, encoded,
    then ``server_aggregate`` from ``round_generator(seed, 0)``."""
    feats, labels = cohort
    sess = _session(shards=1, transfer_seed=4, synthesis=synthesis)
    res = sess.run_sharded(feats, labels, seed=9, device="cpu")
    dev = torch.device("cpu")
    msgs = []
    for i in range(I):
        g = torch.Generator().manual_seed(4 + i)
        params, counts, lls = sess.client_summary(
            torch.from_numpy(feats[i]), torch.from_numpy(labels[i]), i,
            generator=g, device=dev)
        msgs.append(sess.encode(params, counts, lls, i))
    host = dataclasses.replace(sess, shards=None).server_aggregate(
        msgs, generator=A.round_generator(9, 0, dev), device=dev)
    for m_mesh, m_host in zip(res.messages, msgs):
        assert m_mesh.payload == m_host.payload
    for p in ("w", "b"):
        torch.testing.assert_close(res.model[p], host.model[p], rtol=1e-6,
                                   atol=1e-6)


def test_sharded_preconditions_are_actionable(cohort):
    feats, labels = cohort
    base = _session(shards=1)
    f, y = torch.from_numpy(feats), torch.from_numpy(labels)
    with pytest.raises(ValueError, match="bfloat16"):
        dataclasses.replace(base, codec=A.QuantizedCodec("float16")
                            ).run_sharded(f, y, device="cpu")
    with pytest.raises(NotImplementedError, match="Star"):
        dataclasses.replace(base, topology=A.Chain()).run_sharded(
            f, y, device="cpu")
    with pytest.raises(NotImplementedError, match="host"):
        dataclasses.replace(base, dp=DP.DPConfig()).run_sharded(
            f, y, device="cpu")
    with pytest.raises(NotImplementedError, match="GMM summaries"):
        dataclasses.replace(base, summarizer=A.HeadSummarizer()
                            ).run_sharded(f, y, device="cpu")
    with pytest.raises(ValueError, match="does not shard evenly"):
        _session(shards=3).run_sharded(f, y, device="cpu")
    with pytest.raises(ValueError, match="disagree"):
        dataclasses.replace(base, mesh=LM.make_sim_mesh(1, device="cpu"),
                            shards=2).run_sharded(f, y, device="cpu")
    with pytest.raises(ValueError, match="one"):
        base.run([(f[0], y[0]), (f[1, :10], y[1, :10])], device="cpu")


def test_mesh_quarantine_of_a_poisoned_client(cohort, mesh, monkeypatch):
    """With resilience validating, a client whose wire carries NaN is
    quarantined at the mesh wire and the round degrades."""
    from repro_torch.fl import resilience as RS
    feats, labels = cohort
    real = DF.fedpft_transfer

    def poisoned(*a, **kw):
        wire, counts, lls = real(*a, **kw)
        wire["mu"][0, 0, 0, 0] = float("nan")
        return wire, counts, lls
    monkeypatch.setattr(DF, "fedpft_transfer", poisoned)
    sess = _session(shards=1, resilience=RS.ResilienceConfig())
    res = sess.run_sharded(feats, labels, device="cpu")
    assert [q["client_id"] for q in res.info["quarantined"]] == [0]
    assert res.info["faults"] == {"degraded": True, "coverage": 0.5}
    assert len(res.messages) == 1
