"""The port's ``fl/ingest.py`` against ``repro/fl/ingest.py``, and the
streaming laws inside the port.

Host code copied from the reference must agree exactly: splitmix64 slot
priorities bit for bit, and one cohort of clean, tampered, duplicate,
late, over-capacity and after-close submissions must draw the same
verdicts, the same ``accounting()`` dict and the same retained reservoir
(ids, counts, priorities and parameters, exact) from both brokers.
Inside the port, on the CPU and bitwise: ``merge`` is associative and
commutative with ``empty`` as identity, a fold gives the same state at any
chunk size, streaming ≡ fused under capacity (DESIGN §9), and a partial
chaos round ≡ an offline broker round over its survivors (§13).
"""
import numpy as np
import pytest
import torch

from repro.fl import faults as JF
from repro.fl import ingest as JI
from repro_torch.analysis import sanitize
from repro_torch.core import gmm as G
from repro_torch.core import head as H
from repro_torch.fl import api as A
from repro_torch.fl import faults as F
from repro_torch.fl import ingest as I
from repro_torch.fl import resilience as R
from test_torch_resilience import C, _clients, msg_pair


@pytest.mark.parametrize("seed", [0, 3, 2 ** 33 + 1])
def test_slot_priority_is_the_references(seed):
    rng = np.random.RandomState(seed % 1000)
    ids = np.concatenate([np.arange(50), rng.randint(0, 2 ** 40, 50)])
    counts = rng.randint(1, 500, ids.size)
    np.testing.assert_array_equal(I.slot_priority(ids, counts, seed),
                                  JI.slot_priority(ids, counts, seed))


def _cohort():
    """(client id, port message, reference message, arrival time, tamper)
    for one round of every verdict."""
    plan = [(0, None), (1, None), (2, "truncate"), (3, "corrupt"),
            (1, None), (4, "poison"), (5, None), (6, None), (7, None),
            (8, None), (9, None)]
    out = []
    for cid, tamper in plan:
        port, ref = msg_pair(cid, seed=4)
        if tamper is not None:
            port = F._TAMPER[tamper](port, 4, cid)
            ref = JF._TAMPER[tamper](ref, 4, cid)
        out.append((cid, port, ref, 0.0))
    out.append((10, *msg_pair(10, seed=4), 10.0))     # past the deadline
    return out


def _run_broker(mod, cohort, which):
    cfg = mod.IngestConfig(capacity=10, chunk_size=3, max_clients=6,
                           deadline_s=5.0, seed=3)
    now = {"t": 0.0}
    broker = mod.IngestBroker(cfg, C, clock=lambda: now["t"])
    verdicts = []
    for cid, port, ref, t in cohort:
        now["t"] = t
        verdicts.append(broker.submit(cid, port if which == 0 else ref))
    state = broker.close()
    verdicts.append(broker.submit(11, cohort[0][1 + which]))
    return broker, state, verdicts


def test_broker_accounting_and_reservoir_are_the_references():
    cohort = _cohort()
    pb, ps, pv = _run_broker(I, cohort, 0)
    jb, js, jv = _run_broker(JI, cohort, 1)
    assert pv == jv
    assert pv == ["admitted", "admitted", "quarantined", "quarantined",
                  "duplicate", "quarantined", "admitted", "admitted",
                  "admitted", "admitted", "over_cap", "late", "closed"]
    assert pb.accounting() == jb.accounting()
    acct = pb.accounting()
    assert sum(acct[k] for k in ("admitted_bytes", "late_bytes",
                                 "duplicate_bytes", "over_cap_bytes",
                                 "quarantined_bytes", "closed_bytes")) \
        == acct["sent_bytes"]
    assert acct["slots_evicted"] > 0        # the race really ran
    assert pb.admitted_ids == jb.admitted_ids
    assert [(r.client_id, r.reason) for r in pb.rejections] == \
        [(r.client_id, r.reason) for r in jb.rejections]
    for f in ("slot_ids", "priority", "counts", "pi", "mu", "cov"):
        np.testing.assert_array_equal(getattr(ps, f),
                                      np.asarray(getattr(js, f)), f)
    assert (ps.n_clients, ps.slots_seen, ps.mass_seen) == \
        (js.n_clients, js.slots_seen, js.mass_seen)
    for got, want in zip(ps.padded_stack(), js.padded_stack()):
        np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(ps.slot_table().cum_mass,
                                  js.slot_table().cum_mass)


def _state(ids_from, capacity=12, seed=1):
    msgs = [(cid, msg_pair(cid, seed=6)[0]) for cid in ids_from]
    return I.fold_messages(I.IngestState.empty(C, "diag", 2, 8, capacity,
                                               seed), msgs)


def _same(a, b):
    return all(np.array_equal(getattr(a, f), getattr(b, f))
               for f in ("slot_ids", "priority", "counts", "pi", "mu",
                         "cov")) and \
        (a.n_clients, a.slots_seen, a.mass_seen) == \
        (b.n_clients, b.slots_seen, b.mass_seen)


def test_merge_is_associative_commutative_with_identity():
    a, b, c = _state([0, 1]), _state([2, 3, 4]), _state([5, 6])
    e = I.IngestState.empty(C, "diag", 2, 8, 12, 1)
    assert _same(a.merge(b).merge(c), a.merge(b.merge(c)))
    assert _same(a.merge(b), b.merge(a))
    assert _same(a.merge(e), a) and _same(e.merge(a), a)
    with pytest.raises(ValueError, match="incompatible"):
        a.merge(I.IngestState.empty(C, "diag", 2, 8, 12, 2))


@pytest.mark.parametrize("chunk", [1, 2, 5])
def test_fold_is_the_same_at_any_chunk_size(chunk):
    items = [(cid, msg_pair(cid, seed=6)[0]) for cid in range(7)]
    whole = I.fold_messages(I.IngestState.empty(C, "diag", 2, 8, 12, 1),
                            items)
    state = I.IngestState.empty(C, "diag", 2, 8, 12, 1)
    for lo in range(0, len(items), chunk):
        state = I.fold_messages(state, items[lo:lo + chunk][::-1])
    assert _same(state, whole)
    assert whole.evicted == whole.slots_seen - 12 > 0


def _session(**kw):
    return A.FedSession(
        n_classes=C, summarizer=A.GMMSummarizer(G.GMMConfig(2, "diag",
                                                            n_iter=4)),
        head=H.HeadConfig(n_steps=12, batch_size=16, lr=3e-3), **kw)


@pytest.fixture()
def port_sanitized():
    """The port's runtime sanitizer (NaN / Inf checks on every op and
    kernel output, the generator stream tracer) armed for one test; a
    deliberate same-seed rerun calls ``port_sanitized.reset()``."""
    with sanitize() as state:
        yield state


def test_streaming_is_bitwise_the_fused_round_under_capacity(
        port_sanitized):
    data = _clients(5, seed=3)
    fused = _session().run(data, seed=4, device="cpu")
    # each run replays seed 4's streams on purpose
    port_sanitized.reset()
    stream = _session(ingest=I.IngestConfig(capacity=32, chunk_size=2)).run(
        data, seed=4, device="cpu")
    for k in ("w", "b"):
        assert torch.equal(stream.model[k], fused.model[k])
    acct = stream.info["ingest"]
    assert acct["slots_evicted"] == 0 and acct["chunks_folded"] == 3
    assert stream.info["comm_bytes"] == fused.info["comm_bytes"] == \
        acct["sent_bytes"]
    assert acct["peak_resident_bytes"] > 0
    assert stream.info["faults"]["degraded"] is False
    # the messages-in-hand ingest path shares the state machine
    msgs = fused.messages
    dev = torch.device("cpu")
    port_sanitized.reset()
    agg = _session(ingest=I.IngestConfig(capacity=32, chunk_size=2)) \
        .server_aggregate(msgs, generator=A.round_generator(4, 0, dev),
                          device=dev)
    for k in ("w", "b"):
        assert torch.equal(agg.model[k], fused.model[k])
    assert port_sanitized.n_errors == 0 and port_sanitized.n_checked > 0


def test_over_capacity_evicts_and_still_trains():
    data = _clients(6, seed=5)
    res = _session(ingest=I.IngestConfig(capacity=8, chunk_size=4)).run(
        data, device="cpu")
    acct = res.info["ingest"]
    assert acct["slots_retained"] == 8
    assert acct["slots_evicted"] == acct["slots_seen"] - 8 > 0
    assert torch.isfinite(res.model["w"]).all()


def test_partial_chaos_round_is_bitwise_the_offline_survivors():
    data = _clients(12, seed=2)
    icfg = I.IngestConfig(capacity=64, chunk_size=16, deadline_s=5.0)
    sess = _session(ingest=icfg, resilience=R.ResilienceConfig(
        max_retries=2))
    plan = F.FaultPlan(seed=11, drop=0.2, corrupt=0.15, straggle=0.2,
                       straggle_delay_s=100.0, transient=0.2)
    res = sess.run(data, seed=9, device="cpu", faults=plan)
    surv = res.info["faults"]["admitted_clients"]
    acct = res.info["ingest"]
    assert 0 < len(surv) < 12
    assert res.info["faults"]["degraded"]
    assert res.info["faults"]["retries"] > 0
    assert res.info["faults"]["coverage"] == len(surv) / 12
    assert sum(acct[k] for k in ("admitted_bytes", "late_bytes",
                                 "duplicate_bytes", "over_cap_bytes",
                                 "quarantined_bytes", "closed_bytes")) \
        == acct["sent_bytes"]
    dev = torch.device("cpu")
    broker = I.IngestBroker(icfg, C, clock=lambda: 0.0)
    for i in surv:
        f, y = data[i]
        broker.submit(i, sess.client_update(
            f, y, i, generator=A.round_generator(9, 1 + i, dev), device=dev))
    off = sess.aggregate_from_broker(broker, seed=9, device="cpu")
    for k in ("w", "b"):
        assert torch.equal(res.model[k], off.model[k])
    with pytest.raises(ValueError, match="ingest"):
        _session().run(data, device="cpu", faults=plan)
