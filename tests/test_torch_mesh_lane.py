"""The port's mesh lane: the one-shot round over 1, 2 and 4 gloo ranks on
the CPU, against each other and against the JAX reference's 1-shard
round (after ``tests/multidevice/test_shard_invariance.py``, whose
tolerances it keeps).

The 1-rank round runs in this process; four ranks are spawned
(``tests/_torch_mesh_ranks.py``, which imports no JAX), each joining the
4-rank gloo group and then, ranks 0 and 1, the 2-rank one, through file
stores.  The JAX side is computed here.  Checks: the wire with the
reference's draws against the reference's wire, and with the port's own
draws across world sizes; the session (streamed and fused) across world
sizes, the synthetic pool row by row; synthesis over the mesh bit for bit
the run without it; the fused round against the reference's 1-shard
``run_sharded`` (its own draws: by accuracy and agreement of the heads'
predictions); globally disjoint client seeds; the uneven-cohort error;
DTensor placements from ``launch.sharding.named`` on a 2-rank mesh.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import _torch_mesh_ranks as ranks
from repro import data as JD
from repro.core import distributed as JDF
from repro.core import gmm as JG
from repro.core import head as JH
from repro.fl import api as JA
from repro.launch.mesh import make_sim_mesh as jax_sim_mesh
from test_torch_gmm import FIT_TOL, _reference_kmeans_draws

C, I, N, DIM, K = 4, 8, 48, 6, 2
WORLDS = (1, 2, 4)


def _cohort():
    dcfg = JD.DatasetConfig(n_classes=C, n_per_class=120, input_dim=DIM,
                            class_sep=3.0)
    x, y = JD.make_dataset(dcfg)
    return (np.asarray(x[: I * N]).reshape(I, N, DIM),
            np.asarray(y[: I * N]).reshape(I, N).astype(np.int64))


@pytest.fixture(scope="module")
def lane(tmp_path_factory):
    """{world: rank 0's results}, every world's ranks run once."""
    tmp = tmp_path_factory.mktemp("mesh_lane")
    feats, labels = _cohort()
    draws = [_reference_kmeans_draws(
        jax.random.PRNGKey(i), np.asarray(jax.nn.one_hot(labels[i], C)).T,
        C, K, DIM) for i in range(I)]
    inputs = os.path.join(tmp, "inputs.pt")
    torch.save({"feats": torch.from_numpy(feats.copy()),
                "labels": torch.from_numpy(labels), "C": C, "K": K,
                "init_idx": torch.stack([d[0] for d in draws]),
                "jitter": torch.stack([d[1] for d in draws]),
                "synthesis": _synthesis_input()}, inputs)
    for world in WORLDS:
        os.makedirs(os.path.join(tmp, f"w{world}"))
    ctx = mp.get_context("spawn")
    procs = []
    for r in range(max(WORLDS)):
        p = ctx.Process(target=ranks.run, args=(r, WORLDS[:0:-1], str(tmp),
                                                inputs))
        p.start()
        procs.append(p)
    ranks.run(0, (1,), str(tmp), inputs)
    for p in procs:
        p.join(timeout=240)
    assert all(not p.is_alive() and p.exitcode == 0 for p in procs), \
        [(p.is_alive(), p.exitcode) for p in procs]
    res = {w: torch.load(os.path.join(tmp, f"w{w}", "rank0.pt"),
                         weights_only=False) for w in WORLDS}
    # every rank of a world returns the same replicated wire
    for w in WORLDS[1:]:
        for r in range(1, w):
            other = torch.load(os.path.join(tmp, f"w{w}", f"rank{r}.pt"),
                               weights_only=False)
            for f in JG.WIRE_FIELDS:
                assert torch.equal(other["wire_own_draws/diag"][0][f],
                                   res[w]["wire_own_draws/diag"][0][f])
            for p in ("w", "b"):
                assert torch.equal(other["session/fused"]["model"][p],
                                   res[w]["session/fused"]["model"][p])
    return feats, labels, res


def _synthesis_input():
    """A fixed diag wire of 3 clients × 4 classes × K 2 in dim 6, with
    counts that make buckets of 1 to 5 slots (some classes absent)."""
    rng = np.random.RandomState(3)
    pi = rng.rand(3, C, K) + 0.1
    return {"batch": {
        "pi": torch.from_numpy((pi / pi.sum(-1, keepdims=True)).astype(
            np.float32)),
        "mu": torch.from_numpy(rng.randn(3, C, K, DIM).astype(np.float32)),
        "cov": torch.from_numpy((rng.rand(3, C, K, DIM) + 0.1).astype(
            np.float32))},
        "counts": torch.tensor([[5, 0, 17, 40], [9, 33, 0, 3],
                                [70, 12, 6, 1]])}


def _f32(t):
    return t.float().numpy()


@pytest.mark.parametrize("cov", ["diag", "spher"])
def test_wire_with_reference_draws_matches_reference(lane, cov):
    """Every world size, fed the reference's draws, leaves the reference's
    1-shard wire (to the lane's tolerances) and moves exactly Eqs. 9-11
    bytes per rank."""
    feats, labels, res = lane
    cfg = JG.GMMConfig(n_components=K, cov_type=cov, n_iter=5)
    mesh = jax_sim_mesh(1)
    with mesh:
        wire_j, counts_j, lls_j = JDF.fedpft_transfer(
            mesh, jnp.asarray(feats), jnp.asarray(labels.astype(np.int32)),
            C, cfg, seed=0)
    for w in WORLDS:
        wire, counts, lls, by_tag = res[w][f"wire_ref_draws/{cov}"]
        np.testing.assert_array_equal(counts.numpy(), np.asarray(counts_j))
        # port against reference: the full-fit tolerance (FIT_TOL)
        np.testing.assert_allclose(lls.numpy(), np.asarray(lls_j),
                                   rtol=FIT_TOL, atol=FIT_TOL)
        for f in JG.WIRE_FIELDS:
            np.testing.assert_allclose(
                _f32(wire[f]), np.asarray(wire_j[f], np.float32),
                rtol=1e-2, atol=2e-2, err_msg=f"{w} ranks, {cov} {f}")
        assert by_tag["wire"] == JDF.expected_wire_bytes(cov, DIM, K, C,
                                                         I // w)


@pytest.mark.parametrize("cov", ["diag", "spher"])
def test_wire_invariance_across_world_sizes(lane, cov):
    _, _, res = lane
    ref_wire, ref_counts, ref_lls = res[1][f"wire_own_draws/{cov}"]
    for w in WORLDS[1:]:
        wire, counts, lls = res[w][f"wire_own_draws/{cov}"]
        np.testing.assert_array_equal(ref_counts.numpy(), counts.numpy())
        np.testing.assert_allclose(ref_lls.numpy(), lls.numpy(), rtol=1e-4,
                                   atol=1e-4)
        for f in JG.WIRE_FIELDS:
            np.testing.assert_allclose(_f32(ref_wire[f]), _f32(wire[f]),
                                       rtol=1e-2, atol=2e-2)


def test_session_invariance_across_world_sizes(lane):
    """The streamed session — transfer, codec accounting, bucketed
    synthesis split over the ranks, head — agrees across world sizes,
    and comm_bytes is Eqs. 9-11 whatever the world."""
    feats, _, res = lane
    ref = res[1]["session/streamed"]
    for w in WORLDS:
        r = res[w]["session/streamed"]
        assert r["n_shards"] == w
        assert r["comm_bytes"] == r["payload"] == \
            JG.comm_bytes("diag", DIM, K, C, 2) * I
        assert r["mesh_wire_bytes"] == JDF.expected_wire_bytes(
            "diag", DIM, K, C, I)
        for p_ref, p_w in zip(ref["params"], r["params"]):
            for f in JG.WIRE_FIELDS:
                np.testing.assert_allclose(p_ref[f].numpy(), p_w[f].numpy(),
                                           rtol=1e-2, atol=2e-2)
        np.testing.assert_array_equal(ref["pool"][1].numpy(),
                                      r["pool"][1].numpy())
        # row by row: the buckets' rows come back in the 1-rank order
        np.testing.assert_allclose(ref["pool"][0].numpy(),
                                   r["pool"][0].numpy(), rtol=1e-2,
                                   atol=2e-2)
        np.testing.assert_allclose(ref["pool"][0].mean(0).numpy(),
                                   r["pool"][0].mean(0).numpy(), atol=2e-2)
        np.testing.assert_allclose(ref["pool"][0].std(0).numpy(),
                                   r["pool"][0].std(0).numpy(), atol=2e-2)
        for p in ("w", "b"):
            np.testing.assert_allclose(ref["model"][p].numpy(),
                                       r["model"][p].numpy(), rtol=1e-2,
                                       atol=2e-2)
        x0 = torch.from_numpy(feats[0])
        agree = (x0 @ ref["model"]["w"] + ref["model"]["b"]).argmax(-1) \
            == (x0 @ r["model"]["w"] + r["model"]["b"]).argmax(-1)
        assert float(agree.float().mean()) >= 0.98


def test_fused_head_invariance_across_world_sizes(lane):
    _, _, res = lane
    ref = res[1]["session/fused"]
    for w in WORLDS[1:]:
        r = res[w]["session/fused"]
        assert r["pool"] is None
        for p in ("w", "b"):
            np.testing.assert_allclose(ref["model"][p].numpy(),
                                       r["model"][p].numpy(), rtol=1e-2,
                                       atol=2e-2)


def test_synthesis_over_the_mesh_is_the_run_without_it(lane):
    """Every rank draws each bucket whole and transforms its own rows: the
    gathered chunks are the run's without a mesh bit for bit, at every
    world size (buckets of 1 to 5 slots, padded to the world)."""
    _, _, res = lane
    plain = res[1]["synthesis"][1]
    for w in WORLDS:
        with_mesh, without = res[w]["synthesis"]
        assert len(with_mesh) == len(without) == len(plain) > 1
        for (f, y), (f0, y0), (fp, yp) in zip(with_mesh, without, plain):
            assert torch.equal(f, f0) and torch.equal(y, y0)
            assert torch.equal(f, fp) and torch.equal(y, yp)


def test_fused_round_against_the_references_one_shard_round(lane):
    """The fused round at every world size against the reference's
    ``run_sharded`` on a 1-shard mesh.  The two packages draw from their
    own generators (k-means starts, synthesis, head), so the heads are
    held by what they predict: on the cohort's features, accuracy within
    0.02 of the reference head's and the same class for ≥ 95 % of the
    samples."""
    feats, labels, res = lane
    sess = JA.FedSession(
        n_classes=C, summarizer=JA.GMMSummarizer(JG.GMMConfig(
            n_components=K, cov_type="diag", n_iter=5)),
        head=JH.HeadConfig(n_steps=120, lr=3e-3), shards=1,
        synthesis="fused")
    jr = sess.run_sharded(jax.random.PRNGKey(0), jnp.asarray(feats),
                          jnp.asarray(labels.astype(np.int32)))
    assert jr.info["n_shards"] == 1
    x = feats.reshape(-1, DIM)
    y = labels.reshape(-1)
    pred_j = np.asarray(x @ np.asarray(jr.model["w"])
                        + np.asarray(jr.model["b"])).argmax(-1)
    for w in WORLDS:
        m = res[w]["session/fused"]["model"]
        pred = (torch.from_numpy(x) @ m["w"] + m["b"]).argmax(-1).numpy()
        assert abs((pred == y).mean() - (pred_j == y).mean()) <= 0.02, w
        assert (pred == pred_j).mean() >= 0.95, w


def test_client_seeds_disjoint_end_to_end(lane):
    """Identical data on every client: with globally disjoint seeds every
    client's fit still differs, and the fits are those of the 1-rank
    round whatever the world."""
    _, _, res = lane
    for w in WORLDS:
        mu = res[w]["same_data_mu"].float()
        for i in range(I):
            for j in range(i + 1, I):
                assert (mu[i] - mu[j]).abs().max() > 1e-3, (w, i, j)
        np.testing.assert_allclose(mu.numpy(),
                                   res[1]["same_data_mu"].float().numpy(),
                                   rtol=1e-2, atol=2e-2)


def test_uneven_cohort_raises_actionable(lane):
    _, _, res = lane
    for w in WORLDS[1:]:
        assert "does not shard evenly" in res[w]["uneven"], res[w]["uneven"]
        assert f"{w}-way" in res[w]["uneven"]


def test_named_placements_divide_as_specs_say(lane):
    """On a (2, 1) ("data", "model") gloo mesh, each leaf's local shard is
    its global shape with every dim the spec puts on "data" halved."""
    _, _, res = lane
    shapes = res[2]["dtensor"]
    assert any("data" in sp for _, sp, _ in shapes.values())
    for name, (full, spec, local) in shapes.items():
        want = tuple(d // 2 if i < len(spec) and spec[i] == "data" else d
                     for i, d in enumerate(full))
        assert local == want, (name, full, spec, local)
