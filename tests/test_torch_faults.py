"""The port's ``fl/faults.py`` against ``repro/fl/faults.py``.

Fates are host hashes copied from the reference, so for every seed ×
client id the port's ``FaultPlan.fate`` must equal the reference's field
for field, floats included (exact).  ``schedule`` must give the same
arrival times, order and provenance tags; each tamper function applied to
a port-encoded message must give a payload byte-identical to the
reference's tamper of the byte-identical reference message.
"""
import dataclasses

import numpy as np
import pytest

from repro.fl import faults as JF
from repro_torch.fl import faults as F
from test_torch_resilience import C, TAMPERS, msg_pair

PLAN = dict(drop=0.2, straggle=0.25, straggle_delay_s=100.0, truncate=0.1,
            corrupt=0.15, poison=0.1, duplicate=0.2, transient=0.3,
            transient_fails=2, reorder_jitter_s=0.05)


@pytest.mark.parametrize("seed", [0, 7, 11, 2 ** 40 + 3])
def test_fates_are_the_references(seed):
    plan, jplan = F.FaultPlan(seed=seed, **PLAN), JF.FaultPlan(seed=seed,
                                                               **PLAN)
    for cid in list(range(64)) + [10 ** 6, 2 ** 31 - 1]:
        assert dataclasses.astuple(plan.fate(cid)) == \
            dataclasses.astuple(jplan.fate(cid)), cid
        for tag in ("drop", "tamper", "jitter", "cut", "flip"):
            assert F._uniform(seed, cid, tag) == JF._uniform(seed, cid, tag)


def test_fate_rates_hit_their_targets():
    plan = F.FaultPlan(seed=3, drop=0.3, corrupt=0.2, poison=0.1)
    fates = [plan.fate(i) for i in range(4000)]
    assert abs(np.mean([f.drop for f in fates]) - 0.3) < 0.03
    assert abs(np.mean([f.tamper == "corrupt" for f in fates]) - 0.2) < 0.03
    assert abs(np.mean([f.tamper == "poison" for f in fates]) - 0.1) < 0.03
    for bad in ({"drop": 1.5}, {"truncate": 0.6, "corrupt": 0.6},
                {"transient_fails": -1}):
        with pytest.raises(ValueError, match="FaultPlan"):
            F.FaultPlan(**bad)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("kind", TAMPERS)
def test_tampered_payloads_are_byte_identical(kind, seed):
    for cid in range(6):
        port, ref = msg_pair(cid, seed)
        tp = F._TAMPER[kind](port, seed, cid)
        tj = JF._TAMPER[kind](ref, seed, cid)
        assert tp.payload == tj.payload, (kind, cid)
        assert tp.payload != port.payload
        assert dataclasses.asdict(tp.header) == dataclasses.asdict(tj.header)


@pytest.mark.parametrize("seed", [1, 11])
def test_schedule_is_the_references(seed):
    plan, jplan = F.FaultPlan(seed=seed, **PLAN), JF.FaultPlan(seed=seed,
                                                               **PLAN)
    pairs = [msg_pair(cid, 2) for cid in range(12)]
    got = F.schedule(plan, [(cid, p) for cid, (p, _) in enumerate(pairs)],
                     t0=1.5)
    want = JF.schedule(jplan, [(cid, j) for cid, (_, j) in enumerate(pairs)],
                       t0=1.5)
    assert [(e.t, e.client_id, e.fault) for e in got] == \
        [(e.t, e.client_id, e.fault) for e in want]
    assert [e.message.payload for e in got] == \
        [e.message.payload for e in want]
    dropped = {cid for cid in range(12) if plan.fate(cid).drop}
    assert dropped and not dropped & {e.client_id for e in got}
    assert [e.t for e in got] == sorted(e.t for e in got)


def test_flaky_fails_after_doing_the_work():
    calls = []
    fn = F.flaky(lambda x: calls.append(x) or x, 2)
    for _ in range(2):
        with pytest.raises(F.TransientClientError):
            fn(1)
    assert fn(1) == 1 and calls == [1, 1, 1]


def test_tamper_keeps_the_schema():
    port, _ = msg_pair(3)
    assert F.tamper_truncate(port, 0, 3).header == port.header
    poisoned = F.tamper_poison(port, 0, 3)
    first = port.header.present[0]
    assert np.isnan(poisoned.params["mu"][first].numpy()).all()
    assert poisoned.comm_bytes == port.comm_bytes and C == len(
        poisoned.header.counts)
