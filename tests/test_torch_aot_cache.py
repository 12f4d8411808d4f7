"""The port's ``launch/aot_cache.py`` and ``launch/input_specs.py`` against
the reference's, on the CPU (where an entry is the eager round program;
the captured graphs are held on the card by ``tests/test_torch_cuda.py``).

Held exactly: ``canonical_grid`` and ``serving_grid`` list the reference's
signatures (compared as tuples), ``round_specs_for`` gives the reference's
shapes and dtypes, and the cache's LRU order, hits, misses, evictions,
``warmup``, ``snapshot`` and ``delta`` move as the reference's do.  Counters
are asserted, never wall-clock times.  A cached round (cohort padded to its
canonical signature) trains the eager fused head bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.fl import round as JR
from repro.launch import aot_cache as JAC
from repro.launch import input_specs as JIS
from repro_torch.core import gmm as G
from repro_torch.core import head as H
from repro_torch.fl import api as A
from repro_torch.fl import ingest as I
from repro_torch.fl import round as FR
from repro_torch.launch import aot_cache as AC
from repro_torch.launch import input_specs as IS
from test_torch_resilience import C, _clients

HEAD = H.HeadConfig(n_steps=12, batch_size=16, lr=3e-3)


def _tuples(sigs):
    return [dataclasses.astuple(s) for s in sigs]


@pytest.mark.parametrize("kw", [
    {},
    {"Ms": (2, 8), "Ks": (1, 3), "cov_types": ("diag", "spher"),
     "dtypes": ("bfloat16", "float32")},
    {"Ms": (1,), "layout": "slots", "dtypes": ("float32",)}])
def test_canonical_grid_is_the_references(kw):
    assert _tuples(AC.canonical_grid(10, 16, **kw)) == \
        _tuples(JAC.canonical_grid(10, 16, **kw))


@pytest.mark.parametrize("capacity,covs", [(64, ("diag",)),
                                           (100, ("diag", "spher", "full"))])
def test_serving_grid_is_the_references(capacity, covs):
    assert _tuples(AC.serving_grid(capacity, 10, 10, 1280, covs)) == \
        _tuples(JAC.serving_grid(capacity, 10, 10, 1280, covs))
    with pytest.raises(ValueError, match="power of two"):
        AC.canonical_grid(4, 8, Ms=(3,))


@pytest.mark.parametrize("sig", [
    dict(M=4, C=3, K=2, d=8, cov_type="diag"),
    dict(M=2, C=3, K=2, d=5, cov_type="full", dtype="float16"),
    dict(M=16, C=3, K=2, d=8, cov_type="spher", dtype="float32",
         layout="slots"),
    dict(M=8, C=3, K=2, d=4, cov_type="full", dtype="float32",
         layout="slots")])
def test_round_specs_are_the_references(sig):
    got = IS.round_specs_for(FR.CohortSignature(**sig))
    want = JIS.round_specs_for(JR.CohortSignature(**sig))[1:]   # no key
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert g[0] == tuple(w.shape)
        assert str(g[1]).replace("torch.", "") == str(w.dtype)


def _sig(M, K=2, layout="wire"):
    return FR.CohortSignature(M=M, C=C, K=K, d=8, cov_type="diag",
                              dtype="bfloat16" if layout == "wire"
                              else "float32", layout=layout)


def test_lru_order_evictions_and_counters():
    cache = AC.ProgramCache(max_entries=2)
    a = cache.get(_sig(3), HEAD, device="cpu")
    assert a is cache.get(_sig(4), HEAD, device="cpu")      # same canon
    b = cache.get(_sig(5), HEAD, device="cpu")              # M = 8
    assert cache.get(_sig(3), HEAD, device="cpu") is a      # a is newest
    cache.get(_sig(3, K=1), HEAD, device="cpu")             # evicts b
    assert [(k[0].M, k[0].K) for k in cache.keys()] == [(4, 2), (4, 1)]
    assert b not in cache.entries() and a in cache.entries()
    assert cache.stats() == {"entries": 2, "hits": 2, "misses": 3,
                             "evictions": 1, "compiles": 0,
                             "jit_fallbacks": 0, "total_compile_us": 0.0}
    assert a.uses == 3 and not a.aot and a.eager_reason is None
    spc = cache.get(_sig(3), HEAD, samples_per_class=5, device="cpu")
    assert spc is not a and cache.stats()["misses"] == 4
    assert [k[0].K for k in cache.keys()] == [1, 2]         # a evicted
    with pytest.raises(ValueError, match="max_entries"):
        AC.ProgramCache(max_entries=0)
    with pytest.raises(ValueError, match="max_bytes"):
        AC.ProgramCache(max_bytes=-1)


class _Sized(AC.ProgramCache):
    """A cache whose entries claim ``M`` MiB of device memory, so that the
    byte bound is exercised on the CPU (where entries hold none)."""

    def _build(self, canon, head_cfg, samples_per_class, dev):
        entry = super()._build(canon, head_cfg, samples_per_class, dev)
        entry.memory_bytes = canon.M << 20
        return entry


def test_lru_evicts_by_the_bytes_its_entries_hold():
    cache = _Sized(max_bytes=20 << 20)
    cache.get(_sig(4), HEAD, device="cpu")                  # 4 MiB
    cache.get(_sig(8), HEAD, device="cpu")                  # 12 MiB
    cache.get(_sig(4), HEAD, device="cpu")                  # hit: newest
    assert cache.memory_bytes == 12 << 20 and cache.evictions == 0
    cache.get(_sig(16), HEAD, device="cpu")                 # 28 > 20 MiB
    assert [k[0].M for k in cache.keys()] == [4, 16]        # M = 8 went
    assert cache.memory_bytes == 20 << 20 and cache.evictions == 1
    cache.get(_sig(32), HEAD, device="cpu")                 # alone > 20
    assert [k[0].M for k in cache.keys()] == [32]           # newest stays
    assert cache.stats()["evictions"] == 3
    roomy = _Sized(max_bytes=60 << 20)
    roomy.warmup([_sig(m) for m in (4, 8, 16, 32)], HEAD, device="cpu")
    assert roomy.memory_bytes == 60 << 20 and roomy.evictions == 0


def _session(cache, cov="diag", **kw):
    return A.FedSession(
        n_classes=C, summarizer=A.GMMSummarizer(G.GMMConfig(2, cov,
                                                            n_iter=4)),
        head=HEAD, program_cache=cache, **kw)


@pytest.mark.parametrize("cov", ["diag", "spher"])
def test_cached_round_is_bitwise_the_eager_fused_round(cov):
    data = _clients(3, seed=7)
    eager = _session(None, cov).run(data, seed=1, device="cpu")
    cache = AC.ProgramCache()
    res = _session(cache, cov).run(data, seed=1, device="cpu")
    for k in ("w", "b"):
        assert torch.equal(res.model[k], eager.model[k])
    info = res.info["compile"]
    assert set(info) == {"hit", "aot", "signature", "canonical",
                         "compile_us", "run_us", "amortized_us", "cache"}
    assert info["signature"][0] == 3 and info["canonical"][0] == 4
    assert not info["hit"] and info["cache"]["misses"] == 1
    again = _session(cache, cov).run(_clients(4, seed=8), seed=2,
                                     device="cpu")
    assert again.info["compile"]["hit"]
    assert not torch.equal(again.model["w"], res.model["w"])
    assert torch.equal(res.model["w"], eager.model["w"])


@pytest.mark.parametrize("ingest", [False, True])
def test_full_covariance_through_the_cache_is_bitwise_eager(ingest):
    """Full covariance: the wire layout tril-unpacks inside the program
    and the reservoir keeps unpacked rows; both give the eager head."""
    data = _clients(3, seed=7)
    kw = {"ingest": I.IngestConfig(capacity=32)} if ingest else {}
    eager = _session(None, "full", **kw).run(data, seed=1, device="cpu")
    res = _session(AC.ProgramCache(), "full", **kw).run(data, seed=1,
                                                        device="cpu")
    for k in ("w", "b"):
        assert torch.equal(res.model[k], eager.model[k])
    assert res.info["compile"]["cache"]["misses"] == 1


def test_warm_serving_grid_serves_the_streaming_round():
    cache = AC.ProgramCache()
    stats = cache.warmup(AC.serving_grid(32, C, 2, 8), HEAD, device="cpu")
    assert stats["misses"] == 1 and stats["entries"] == 1
    before = cache.snapshot()
    data = _clients(5, seed=3)
    icfg = I.IngestConfig(capacity=32, chunk_size=2)
    res = _session(cache, ingest=icfg).run(data, seed=4, device="cpu")
    delta = cache.delta(before)
    assert delta["compiles"] == 0 and delta["misses"] == 0
    assert delta["hits"] == 1
    assert res.info["compile"]["hit"]
    plain = _session(None, ingest=icfg).run(data, seed=4, device="cpu")
    for k in ("w", "b"):
        assert torch.equal(res.model[k], plain.model[k])


def test_heterogeneous_cohort_bypasses_the_cache():
    data = _clients(2, seed=1)
    cache = AC.ProgramCache()
    sess = A.FedSession(
        n_classes=C, head=HEAD, program_cache=cache,
        client_summarizers=(A.GMMSummarizer(G.GMMConfig(2, "diag",
                                                        n_iter=3)),
                            A.GMMSummarizer(G.GMMConfig(1, "diag",
                                                        n_iter=3))))
    res = sess.run(data, device="cpu")
    assert res.info["synthesis"] == "pooled" and len(cache) == 0
    assert "compile" not in res.info and np.isfinite(
        res.model["w"].numpy()).all()
