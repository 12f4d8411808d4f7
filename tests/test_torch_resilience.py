"""The port's ``fl/resilience.py`` against ``repro/fl/resilience.py``.

Both packages validate byte-identical messages (the same parameters
encoded by each side's codec): ``validate_message`` must give the same
``reason`` and the same byte count for clean, truncated, bit-corrupted,
NaN-poisoned and malformed-header messages (exact comparison).  The retry
contract is held in law inside the port: a retried client's message is
its clean first attempt's, byte for byte, and a Star round with a flaky
client trains the clean round's head bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.fl import api as JA
from repro.fl import faults as JF
from repro.fl import resilience as JR
from repro_torch.core import gmm as G
from repro_torch.core import head as H
from repro_torch.fl import api as A
from repro_torch.fl import faults as F
from repro_torch.fl import resilience as R

C, K, D = 4, 2, 8
TAMPERS = ("truncate", "corrupt", "poison")


def msg_pair(cid, seed=0, counts=None, dtype="bfloat16", cov="diag"):
    """One client's message from each package, encoded from the same
    parameters: byte-identical payloads and headers."""
    rng = np.random.RandomState(1000 * seed + cid)
    params = {"pi": rng.dirichlet(np.ones(K), C).astype(np.float32),
              "mu": (rng.randn(C, K, D) + 3 * np.eye(C, D)[:, None])
              .astype(np.float32),
              "cov": (rng.rand(*((C, K, D) if cov == "diag" else (C, K)))
                      + 0.2).astype(np.float32)}
    if counts is None:
        counts = rng.randint(0, 30, C)
        counts[cid % C] = max(counts[cid % C], 1)
    counts = np.asarray(counts, np.int64)
    lls = rng.randn(C).astype(np.float32)
    kw = dict(kind="gmm", cov_type=cov, n_classes=C)
    port = A.encode_message({k: torch.from_numpy(v) for k, v in
                             params.items()}, counts, lls,
                            codec=A.QuantizedCodec(dtype), **kw)
    ref = JA.encode_message(params, counts, lls,
                            codec=JA.QuantizedCodec(dtype), **kw)
    assert port.payload == ref.payload
    return port, ref


def tampered_pair(kind, cid, seed):
    port, ref = msg_pair(cid, seed)
    return (F._TAMPER[kind](port, seed, cid),
            JF._TAMPER[kind](ref, seed, cid))


def _with_header(pair, **change):
    port, ref = pair
    return (dataclasses.replace(port, header=dataclasses.replace(
                port.header, **change)),
            dataclasses.replace(ref, header=dataclasses.replace(
                ref.header, **change)))


def _malformed(cid):
    pair = msg_pair(cid)
    counts = list(pair[0].header.counts)
    return {
        "head_kind": _with_header(pair, kind="head"),
        "cov_type": _with_header(pair, cov_type="block"),
        "zero_K": _with_header(pair, K=0),
        "n_classes": _with_header(pair, n_classes=C + 1),
        "negative_count": _with_header(
            pair, counts=tuple([-1] + counts[1:])),
        "dtype": _with_header(pair, dtype="int3"),
        "float64_dtype": _with_header(pair, dtype="float64"),
    }


class TestValidateMessage:
    @pytest.mark.parametrize("seed", [0, 3])
    @pytest.mark.parametrize("cid", [0, 1, 2, 5])
    def test_reasons_match_on_tampered_messages(self, cid, seed):
        cases = {"clean": msg_pair(cid, seed)}
        cases.update({t: tampered_pair(t, cid, seed) for t in TAMPERS})
        for name, (port, ref) in cases.items():
            rt = R.validate_message(port, C, client_id=cid)
            rj = JR.validate_message(ref, C, client_id=cid)
            if rj is None:
                assert rt is None, (name, rt)
                continue
            assert (rt.reason, rt.comm_bytes, rt.client_id) == \
                (rj.reason, rj.comm_bytes, rj.client_id), name
        assert R.validate_message(cases["clean"][0], C) is None
        for t, want in zip(TAMPERS, ("length_mismatch", "non_finite",
                                     "non_finite")):
            assert R.validate_message(cases[t][0], C).reason == want

    @pytest.mark.parametrize("case", ["head_kind", "cov_type", "zero_K",
                                      "n_classes", "negative_count",
                                      "dtype", "float64_dtype"])
    def test_reasons_match_on_malformed_headers(self, case):
        port, ref = _malformed(2)[case]
        rt = R.validate_message(port, C, client_id=2)
        rj = JR.validate_message(ref, C, client_id=2)
        assert (rt.reason, rt.detail, rt.comm_bytes) == \
            (rj.reason, rj.detail, rj.comm_bytes)

    def test_schema_mismatch(self):
        port, ref = msg_pair(1)
        for expect in (("diag", K + 1, D), ("spher", K, D), ("diag", K, 9)):
            rt = R.validate_message(port, C, expect=expect)
            rj = JR.validate_message(ref, C, expect=expect)
            assert rt.reason == rj.reason == "schema_mismatch"
            assert rt.detail == rj.detail
        assert R.validate_message(port, C, expect=("diag", K, D)) is None

    def test_partition_valid_keeps_positions(self):
        msgs = [msg_pair(0)[0], tampered_pair("corrupt", 1, 0)[0],
                msg_pair(2)[0], tampered_pair("truncate", 3, 0)[0]]
        ok, rejs = R.partition_valid(msgs, C)
        assert ok == [msgs[0], msgs[2]]
        assert [(r.client_id, r.reason) for r in rejs] == \
            [(1, "non_finite"), (3, "length_mismatch")]
        assert all(r.comm_bytes == msgs[r.client_id].comm_bytes
                   for r in rejs)
        with pytest.raises(ValueError, match="reason"):
            R.Rejection(client_id=0, reason="bogus", detail="",
                        comm_bytes=0)


class TestRetry:
    def test_backoff_schedule_is_the_references(self):
        for kw in ({}, {"backoff_base_s": 0.25, "backoff_factor": 3.0}):
            assert R.backoff_schedule(R.ResilienceConfig(**kw), 4) == \
                JR.backoff_schedule(JR.ResilienceConfig(**kw), 4)

    def test_retry_recovers_then_exhausts(self):
        cfg = R.ResilienceConfig(max_retries=2)
        waits = []
        fn = F.flaky(lambda: "msg", 2)
        assert R.call_with_retry(fn, cfg, advance=waits.append) == \
            (True, "msg", 3, 1.5)
        assert waits == [0.5, 1.0] and fn.calls == 3
        dead = F.flaky(lambda: "msg", 5)
        assert R.call_with_retry(dead, cfg) == (False, None, 3, 1.5)

    @pytest.mark.parametrize("kw", [{"max_retries": -1},
                                    {"backoff_base_s": -1.0},
                                    {"backoff_factor": 0.5}])
    def test_config_validation(self, kw):
        with pytest.raises(ValueError, match="ResilienceConfig"):
            R.ResilienceConfig(**kw)


def _clients(m, seed=0, n=40):
    rng = np.random.default_rng(seed)
    return [(torch.from_numpy(rng.normal(size=(n, D)).astype(np.float32)
                              + np.eye(C, D)[i % C] * 3),
             torch.from_numpy(rng.integers(0, C, n).astype(np.int64)))
            for i in range(m)]


def _session(**kw):
    return A.FedSession(
        n_classes=C, summarizer=A.GMMSummarizer(G.GMMConfig(K, "diag",
                                                            n_iter=4)),
        head=H.HeadConfig(n_steps=12, batch_size=16, lr=3e-3), **kw)


class TestRetryReplaysTheClient:
    def test_retried_message_is_the_clean_first_attempt(self):
        sess = _session(resilience=R.ResilienceConfig(max_retries=2))
        (f, y), = _clients(1)
        dev = torch.device("cpu")
        clean = sess.client_update(f, y, 0,
                                   generator=A.round_generator(5, 1, dev),
                                   device=dev)
        stats = A._fault_stats()
        waits = []
        msg = sess._client_attempt(
            f, y, 0, stats, seed=5, device=dev, advance=waits.append,
            client_fn=F.flaky(sess.client_update, 2))
        assert msg.payload == clean.payload
        assert msg.header == clean.header
        assert stats == {"attempts": 3, "retries": 2, "backoff_s": 1.5,
                         "failed": []}
        assert waits == [0.5, 1.0]

    def test_star_round_with_a_flaky_client_trains_the_clean_head(self):
        data = _clients(3, seed=1)
        clean = _session().run(data, seed=2, device="cpu")
        sess = _session(resilience=R.ResilienceConfig(max_retries=1))
        # FedSession is frozen; route around it for the fault stub
        object.__setattr__(sess, "client_update",
                           F.flaky(sess.client_update, 1))
        res = sess.run(data, seed=2, device="cpu")
        for k in ("w", "b"):
            assert torch.equal(res.model[k], clean.model[k])
        assert res.info["faults"]["retries"] == 1
        dead = _session(resilience=R.ResilienceConfig(max_retries=1))
        object.__setattr__(dead, "client_update",
                           F.flaky(dead.client_update, 10))
        with pytest.raises(R.TransientClientError, match="ingest"):
            dead.run(data, device="cpu")

    def test_host_path_quarantines_malformed_messages(self):
        """resilience.validate on the non-streaming server: a corrupted
        message is dropped with a record, and the head is the one the
        clean messages alone train (same server stream)."""
        msgs = [msg_pair(i)[0] for i in range(3)]
        bad = F.tamper_corrupt(msg_pair(3)[0], 0, 3)
        sess = _session(resilience=R.ResilienceConfig())
        dev = torch.device("cpu")
        res = sess.server_aggregate(
            msgs + [bad], generator=A.round_generator(0, 0, dev), device=dev)
        want = _session().server_aggregate(
            msgs, generator=A.round_generator(0, 0, dev), device=dev)
        for k in ("w", "b"):
            assert torch.equal(res.model[k], want.model[k])
        assert [q["reason"] for q in res.info["quarantined"]] == \
            ["non_finite"]
        assert res.info["quarantined_bytes"] == bad.comm_bytes
        assert res.info["faults"] == {"degraded": True, "coverage": 0.75}
