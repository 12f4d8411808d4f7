"""The port's spans and counters (``repro_torch.obs``): off, a span is the
shared no-op object and nothing is recorded or launched; under a profiler,
spans nest, carry their request's ``rid``, lie around the profiler's own
events, and the program's sites count what they run: a Star round's EM
iterations and head steps (its ``phase_s`` read from the spans), the
backbone's blocks, and the service's tokens, slot positions and queue
intervals."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.core import gmm as G
from repro_torch.core import head as H
from repro_torch.fl import api as A
from repro_torch.fl import ingest as IG
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.serve import pow2_bucket
from repro_torch.serve.service import FedPFTService, ServiceConfig

@pytest.fixture(autouse=True)
def fresh():
    obs.reset()
    yield
    obs.reset()


def _traced():
    return profile(activities=[ProfilerActivity.CPU])


def _names(snap):
    return [s["name"] for s in snap["spans"]]


def test_off_a_span_is_the_shared_no_op_and_records_nothing(monkeypatch):
    def forbidden(*a, **k):
        raise AssertionError("called while tracing is off")
    monkeypatch.setattr(torch.profiler, "record_function", forbidden)
    monkeypatch.setattr(torch.cuda, "Event", forbidden)
    monkeypatch.setattr(torch.cuda, "synchronize", forbidden)
    cuda = torch.device("cuda")
    a = obs.span("a", device=cuda)
    assert a is obs.span("b", rid=3) is obs.span("c", device=torch.ones(1))
    with a:
        with obs.span("d", device=cuda):
            obs.count("n", 5)
            obs.interval("q", 1, 2, rid=1)
    with obs.span("t", timed=True, device=cuda) as t:
        pass
    assert t is not a and t.seconds >= 0.0
    assert obs.snapshot() == {"spans": [], "counters": {}}


def test_on_spans_nest_carry_their_rid_and_fill_counters():
    with _traced():
        with obs.span("outer", rid=7):
            with obs.span("inner", rid=7):
                obs.count("n", 2)
            with obs.span("sibling"):
                obs.count("n", 3)
        obs.interval("q", 10, 20, rid=7)
    obs.count("n", 100)                          # off again: not counted
    snap = obs.snapshot()
    assert _names(snap) == ["outer", "inner", "sibling", "q"]
    outer, inner, sib, q = snap["spans"]
    assert outer["parent"] is None and inner["parent"] == 0 \
        and sib["parent"] == 0
    assert (outer["rid"], inner["rid"], sib["rid"]) == (7, 7, None)
    assert (q["t0_ns"], q["t1_ns"], q["rid"], q["parent"]) == (10, 20, 7,
                                                               None)
    assert outer["t0_ns"] <= inner["t0_ns"] <= inner["t1_ns"] \
        <= sib["t0_ns"] <= sib["t1_ns"] <= outer["t1_ns"]
    assert all(s["device_ms"] is None for s in snap["spans"])
    assert snap["counters"] == {"n": 5}


class _FakeEvent:
    """A CUDA timing event's stand-in: elapsed ms is the gap between the
    two record() calls' order numbers."""
    made = []

    def __init__(self, enable_timing=False):
        assert enable_timing
        _FakeEvent.made.append(self)

    def record(self, stream):
        self.at = len(_FakeEvent.made)

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return float(end.at - self.at)


@pytest.mark.parametrize("capturing", [False, True])
def test_a_device_span_times_by_cuda_events_except_under_capture(
        monkeypatch, capturing):
    _FakeEvent.made = []
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: None)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing)
    with _traced():
        with obs.span("d", device=torch.device("cuda")):
            with obs.span("h"):
                pass
            with obs.span("inner", device=torch.device("cuda")):
                pass
    d, h, inner = obs.snapshot()["spans"]
    assert h["device_ms"] is None
    if capturing:
        assert _FakeEvent.made == [] and d["device_ms"] is None
    else:    # d's start, inner's start and end, d's end
        assert len(_FakeEvent.made) == 4
        assert (d["device_ms"], inner["device_ms"]) == (3.0, 1.0)
        assert obs.snapshot()["spans"][0]["device_ms"] == 3.0   # resolved


def test_each_profiler_event_lies_within_its_span():
    with _traced() as prof:
        for i in range(3):
            with obs.span(f"s{i}"):
                torch.ones(64).add_(1)
    spans = {s["name"]: s for s in obs.snapshot()["spans"]}
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith(obs.PREFIX)]
    assert sorted(e.name() for e in events) == [
        obs.PREFIX + n for n in sorted(spans)]
    for e in events:
        s = spans[e.name()[len(obs.PREFIX):]]
        assert e.start_ns() >= s["t0_ns"] - 50_000
        assert e.end_ns() <= s["t1_ns"] + 50_000


def _round(n_clients=3, n_iter=3, n_steps=5, d=8, C=3, N=24):
    g = torch.Generator().manual_seed(0)
    clients = [(torch.randn(N, d, generator=g),
                torch.randint(0, C, (N,), generator=g))
               for _ in range(n_clients)]
    sess = A.FedSession(
        n_classes=C,
        summarizer=A.GMMSummarizer(G.GMMConfig(2, "diag", n_iter=n_iter,
                                               kmeans_iter=2)),
        head=H.HeadConfig(n_steps=n_steps, batch_size=8))
    return sess.run(clients, seed=5, device="cpu")


def test_a_star_round_counts_em_iterations_and_head_steps():
    with _traced():
        res = _round()
    snap = obs.snapshot()
    assert snap["counters"] == {"fl.client.em_iters": 3 * 3,
                                "fl.server.head_steps": 5}
    names = _names(snap)
    assert names.count("fl.client.fit") == names.count("fl.encode") \
        == names.count("fl.client.em") == 3
    assert names.count("fl.server") == names.count("fl.server.head") == 1
    spans = snap["spans"]
    outer = {"fl.client.em": "fl.client.fit", "fl.server.head": "fl.server"}
    for s in spans:
        if s["name"] in outer:
            assert spans[s["parent"]]["name"] == outer[s["name"]]

    def dur(name):
        return sum((s["t1_ns"] - s["t0_ns"]) * 1e-9 for s in spans
                   if s["name"] == name)
    phase = res.info["phase_s"]
    assert phase["client_fit_s"] == pytest.approx(dur("fl.client.fit"),
                                                  rel=1e-12)
    assert phase["encode_s"] == pytest.approx(dur("fl.encode"), rel=1e-12)
    assert phase["server_s"] == pytest.approx(dur("fl.server"), rel=1e-12)


def test_phase_s_is_timed_with_tracing_off():
    res = _round(n_clients=2)
    assert set(res.info["phase_s"]) == {"client_fit_s", "encode_s",
                                        "server_s"}
    assert all(v > 0 for v in res.info["phase_s"].values())
    assert obs.snapshot() == {"spans": [], "counters": {}}


TINY_HYBRID = ModelConfig(
    name="tiny-hybrid", family="hybrid", n_layers=5, d_model=32, n_heads=2,
    n_kv_heads=2, head_dim=16, d_ff=64, vocab_size=32, ssm_state=8,
    ssm_head_dim=16, ssm_expand=2, conv_width=4, chunk_size=8, attn_every=2,
    dtype="float32")


def test_the_backbone_spans_each_block():
    cfg = TINY_HYBRID
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 8))
    with _traced():
        M.features(cfg, params, {"tokens": tokens}, device="cpu")
    names = _names(obs.snapshot())
    assert names.count("model.mamba_block") == 5
    assert names.count("model.transformer_block") == 5 // 2
    assert len(names) == 5 + 5 // 2


TINY_DENSE = ModelConfig(
    name="tiny-dense", family="dense", n_layers=2, d_model=32, n_heads=2,
    n_kv_heads=2, head_dim=16, d_ff=64, vocab_size=64, dtype="float32")


def test_the_service_counts_tokens_positions_and_queue_intervals():
    cfg = TINY_DENSE
    params = M.init_params(cfg, torch.Generator().manual_seed(1),
                           device="cpu")
    sess = A.FedSession(n_classes=3,
                        summarizer=A.GMMSummarizer(G.GMMConfig(2, "diag")),
                        ingest=IG.IngestConfig(capacity=8, chunk_size=4))
    scfg = ServiceConfig(n_slots=4, max_seq=32)
    svc = FedPFTService(cfg, params, sess, scfg, device="cpu")
    lengths = [3, 17, 5, 9, 6, 2]
    rng = np.random.default_rng(0)
    with _traced():
        reqs = [svc.submit_extract(rng.integers(1, cfg.vocab_size, size=L))
                for L in lengths]
        svc.drain()
    snap = obs.snapshot()
    # two steps: the first four prompts (bucket 32), then the last two (8)
    buckets = [pow2_bucket(max(lengths[:4]), scfg.min_bucket, 32),
               pow2_bucket(max(lengths[4:]), scfg.min_bucket, 32)]
    assert snap["counters"] == {
        "serve.real_tokens": sum(lengths),
        "serve.slot_positions": scfg.n_slots * sum(buckets)}
    queued = [s for s in snap["spans"] if s["name"] == "serve.queued"]
    assert sorted(s["rid"] for s in queued) == sorted(r.rid for r in reqs)
    for s in queued:
        r = reqs[[q.rid for q in reqs].index(s["rid"])]
        assert (s["t0_ns"], s["t1_ns"]) == (r.ns_submit, r.ns_admit)
        assert s["t0_ns"] <= s["t1_ns"]
    names = _names(snap)
    assert names.count("serve.step") == names.count("serve.step.fetch") == 2
    st = svc.stats()["extract"]
    assert st["n"] == 6 and 0 <= st["wait_p50_us"] <= st["wait_p99_us"]
