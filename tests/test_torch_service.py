"""The port's FedPFT-as-a-service: extraction through the slot pool, GMM
wire messages through the broker, the head served after ``close_round``.

Features are held against the JAX package's ``serve.make_feature_step``
on the same weights (1e-4, f32); the served head is bitwise the port's
offline ``FedSession(ingest=…, program_cache=…).run`` head on the same
features and seed; the admission, deadline and partial-round laws are
``tests/test_server.py``'s.  ``reduced()`` granite-3-2b in f32, 3
classes, diag K = 2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serve as JS
from repro.configs import get_config as j_get_config
from repro.models import model as JM
from repro_torch.analysis import sanitize
from repro_torch.core import gmm as G
from repro_torch.core import head as H
from repro_torch.fl import ingest as IG
from repro_torch.fl.api import FedSession, GMMSummarizer, round_generator
from repro_torch.launch.aot_cache import ProgramCache
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve.service import (AdmissionError, FedPFTService,
                                       ServiceConfig)

DEV = torch.device("cpu")


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(j_get_config("granite-3-2b").reduced(),
                               dtype="float32", remat=False)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    jp = JM.init_params(jcfg, jax.random.PRNGKey(3))
    tp = params_from_numpy(
        tcfg, jax.tree.map(lambda a: np.asarray(a, np.float32), jp),
        device="cpu")
    return jcfg, jp, tcfg, tp


def _session(capacity=16, cache=None, deadline_s=None):
    return FedSession(n_classes=3,
                      summarizer=GMMSummarizer(G.GMMConfig(2, "diag")),
                      ingest=IG.IngestConfig(capacity=capacity, chunk_size=4,
                                             deadline_s=deadline_s),
                      program_cache=cache)


def _service(model, cache=None, clock=None, deadline_s=None, **kw):
    _, _, tcfg, tp = model
    extra = {} if clock is None else {"clock": clock}
    return FedPFTService(tcfg, tp, _session(cache=cache,
                                            deadline_s=deadline_s),
                         ServiceConfig(n_slots=4, max_seq=32, **kw),
                         device="cpu", **extra)


def _extract_cohort(svc, rng, n_clients=3, n_per=12, n_classes=3):
    """Client datasets whose features come through the SERVICE."""
    reqs = {c: [svc.submit_extract(rng.integers(
        1, svc.cfg.vocab_size, size=int(rng.integers(3, 20))))
        for _ in range(n_per)] for c in range(n_clients)}
    svc.drain()
    return [(torch.from_numpy(np.stack([r.feats for r in reqs[c]])),
             torch.from_numpy(rng.integers(0, n_classes, size=n_per)))
            for c in range(n_clients)]


def _submit_cohort(svc, datasets, seed):
    for i, (f, y) in enumerate(datasets):
        msg = svc.session.client_update(
            f, y, i, generator=round_generator(seed, 1 + i, DEV), device=DEV)
        assert svc.submit_update(i, msg) == "admitted"


def _same_head(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


def test_features_match_the_reference_feature_step(model):
    """One serving step's features against the reference's masked feature
    step on the same right-padded batch (bucket 16, a row of length 0)."""
    jcfg, jp, tcfg, _ = model
    svc = _service(model)
    rng = np.random.default_rng(5)
    lengths = [3, 16, 9]
    reqs = [svc.submit_extract(rng.integers(1, tcfg.vocab_size, size=L))
            for L in lengths]
    assert svc.step() == 3
    tokens = np.zeros((4, 16), np.int32)
    for i, r in enumerate(reqs):
        tokens[i, :lengths[i]] = r.tokens
    exp = np.asarray(JS.make_feature_step(jcfg)(
        jp, jnp.asarray(tokens), jnp.asarray(lengths + [0], jnp.int32)))
    got = np.stack([r.feats for r in reqs])
    np.testing.assert_allclose(got, exp[:3], rtol=1e-4, atol=1e-4)
    # a padded row is exactly its unpadded features
    alone = svc._feats(svc.params, torch.from_numpy(reqs[0].tokens)[None],
                       torch.tensor([3]))
    np.testing.assert_allclose(got[0], alone[0].numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.fixture()
def port_sanitized():
    """The port's runtime sanitizer (NaN / Inf checks on every op and
    kernel output, the generator stream tracer) armed for one test; a
    deliberate same-seed rerun calls ``port_sanitized.reset()``."""
    with sanitize() as state:
        yield state


def test_service_head_bitwise_the_offline_session(model, port_sanitized):
    """Extraction through the pool, messages through the broker, the close
    through the warmed program cache: the head is bitwise the offline
    streaming session's on the same features and seed, and the close
    builds nothing."""
    svc = _service(model, cache=ProgramCache())
    datasets = _extract_cohort(svc, np.random.default_rng(11))
    svc.warmup(d=datasets[0][0].shape[-1])
    _submit_cohort(svc, datasets, seed=9)
    misses0 = svc.session.program_cache.misses
    res = svc.close_round(seed=9)
    assert svc.session.program_cache.misses == misses0
    # the offline session replays seed 9's streams on purpose
    port_sanitized.reset()
    off = _session(cache=ProgramCache()).run(datasets, seed=9, device="cpu")
    assert _same_head(res.model, off.model)
    assert res.info["comm_bytes"] == off.info["comm_bytes"]
    assert port_sanitized.n_errors == 0 and port_sanitized.n_checked > 0


def test_interleaved_extract_and_infer(model):
    """After the first round both classes share the pool; each inference
    label is the head's argmax on that request's own features."""
    svc = _service(model)
    rng = np.random.default_rng(12)
    datasets = _extract_cohort(svc, rng)
    _submit_cohort(svc, datasets, seed=10)
    svc.close_round(seed=10)
    ext = [svc.submit_extract(rng.integers(1, svc.cfg.vocab_size,
                                           size=int(rng.integers(3, 20))))
           for _ in range(6)]
    inf = [svc.submit_infer(rng.integers(1, svc.cfg.vocab_size,
                                         size=int(rng.integers(3, 20))))
           for _ in range(6)]
    svc.drain()
    assert all(r.done for r in ext + inf)
    assert all(r.feats is not None for r in ext)
    for r in inf:
        f = svc._feats(svc.params, torch.from_numpy(r.tokens)[None],
                       torch.tensor([r.tokens.shape[0]]))
        assert r.label == int(torch.argmax(H.head_logits(svc.head, f), -1))
    st = svc.stats()
    assert st["extract"]["n"] >= 6 and st["infer"]["n"] == 6
    assert st["infer"]["p99_us"] >= st["infer"]["p50_us"] >= 0


def test_service_requires_ingest(model):
    _, _, tcfg, tp = model
    sess = FedSession(n_classes=3,
                      summarizer=GMMSummarizer(G.GMMConfig(2, "diag")))
    with pytest.raises(ValueError, match="ingest"):
        FedPFTService(tcfg, tp, sess, device="cpu")


def test_infer_needs_a_head(model):
    svc = _service(model)
    with pytest.raises(RuntimeError, match="close_round"):
        svc.submit_infer(np.arange(1, 5))
    assert svc.rejected_no_head == 1


def test_guaranteed_extract_share(model):
    """With both queues backed up, one step admits ceil(share·B) extract
    rows and fills the rest with inference."""
    svc = _service(model, extract_share=0.5)
    svc.head = {"w": torch.zeros((svc.cfg.d_model, 3)),
                "b": torch.zeros((3,))}
    rng = np.random.default_rng(13)
    for _ in range(8):
        svc.submit_extract(rng.integers(1, svc.cfg.vocab_size, size=5))
        svc.submit_infer(rng.integers(1, svc.cfg.vocab_size, size=5))
    assert svc.step() == 4
    st = svc.stats()
    assert st["extract"]["n"] == 2 and st["infer"]["n"] == 2


def test_feature_shapes_bounded_by_buckets(model):
    svc = _service(model)
    rng = np.random.default_rng(14)
    for L in (3, 5, 9, 11, 17, 19):
        svc.submit_extract(rng.integers(1, svc.cfg.vocab_size, size=L))
    svc.drain()
    n0 = svc.feature_compiles()
    assert n0 <= 3                      # buckets 8, 16, 32
    for L in (4, 6, 10, 12, 18, 20):
        svc.submit_extract(rng.integers(1, svc.cfg.vocab_size, size=L))
    svc.drain()
    assert svc.feature_compiles() == n0


def test_prompt_validation(model):
    svc = _service(model)
    with pytest.raises(ValueError, match="max_seq"):
        svc.submit_extract(np.ones(33, np.int64))
    with pytest.raises(ValueError, match="prompt"):
        svc.submit_extract(np.ones((2, 3), np.int64))
    with pytest.raises(ValueError, match="extract_share"):
        ServiceConfig(extract_share=1.5)


# -- deadline admission control (DESIGN.md §13) -----------------------------


def test_sheds_extract_near_deadline(model):
    t = {"now": 0.0}
    svc = _service(model, clock=lambda: t["now"], deadline_s=10.0,
                   deadline_guard_s=3.0)
    prompt = np.random.default_rng(21).integers(1, svc.cfg.vocab_size,
                                                size=5)
    assert svc.submit_extract(prompt).kind == "extract"   # plenty of time
    t["now"] = 8.0                                        # 2 s left < guard
    with pytest.raises(AdmissionError, match="deadline_guard"):
        svc.submit_extract(prompt)
    assert svc.stats()["shed_extracts"] == 1
    assert len(svc.queues["extract"]) == 1                # nothing parked


def test_defers_extract_to_next_round(model):
    t = {"now": 0.0}
    svc = _service(model, clock=lambda: t["now"], deadline_s=10.0,
                   deadline_guard_s=3.0, extract_admission="defer")
    rng = np.random.default_rng(22)
    datasets = _extract_cohort(svc, rng, n_clients=2, n_per=8)
    _submit_cohort(svc, datasets, seed=23)
    t["now"] = 9.0
    late = svc.submit_extract(rng.integers(1, svc.cfg.vocab_size, size=6))
    assert late.deferred and not svc.queues["extract"]
    st = svc.stats()
    assert st["deferred_extracts"] == 1 and st["deferred_pending"] == 1
    svc.close_round(seed=23)
    assert [r.rid for r in svc.queues["extract"]] == [late.rid]
    svc.drain()
    assert late.done and late.feats is not None
    assert svc.stats()["deferred_pending"] == 0


def test_partial_round_equals_offline_survivors(model):
    """A corrupt payload and a straggler degrade the round; the served head
    is bitwise the one an offline broker fed only the admitted clients
    gives, and every submitted byte lands in one verdict."""
    t = {"now": 0.0}
    svc = _service(model, clock=lambda: t["now"], deadline_s=10.0)
    datasets = _extract_cohort(svc, np.random.default_rng(24), n_clients=4,
                               n_per=8)
    msgs = [svc.session.client_update(
        f, y, i, generator=round_generator(25, 1 + i, DEV), device=DEV)
        for i, (f, y) in enumerate(datasets)]
    assert svc.submit_update(0, msgs[0]) == "admitted"
    assert svc.submit_update(1, msgs[1]) == "admitted"
    bad = dataclasses.replace(msgs[2], payload=msgs[2].payload[:-5])
    assert svc.submit_update(2, bad) == "quarantined"
    t["now"] = 11.0
    assert svc.submit_update(3, msgs[3]) == "late"
    acct = svc.broker.accounting()
    assert acct["admitted_bytes"] + acct["quarantined_bytes"] \
        + acct["late_bytes"] == acct["sent_bytes"]
    res = svc.close_round(seed=25)
    assert res.info["faults"]["degraded"]
    assert svc.submit_update(3, msgs[3]) == "admitted"   # next round
    off = IG.IngestBroker(IG.IngestConfig(capacity=16, chunk_size=4), 3,
                          clock=lambda: 0.0)
    off.submit(0, msgs[0])
    off.submit(1, msgs[1])
    res_off = svc.session.aggregate_from_broker(off, seed=25, device="cpu")
    assert _same_head(res.model, res_off.model)
