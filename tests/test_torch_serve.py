"""The port's continuous-batching server against the JAX package's and the
port's own sequential greedy generation.

Exact tokens, as ``tests/test_server.py`` asserts: the reference's
``BatchedServer`` on the reference's weights, and the port's
``BatchedServer`` on the same weights carried into the port
(``models.convert.params_from_numpy``), give the same token streams, and
each equals the port's ``greedy_generate`` of that prompt alone.  f32,
``reduced()`` granite-3-2b; the ssm and hybrid backbones prefill at their
exact lengths.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import model as JM
from repro.serve.server import BatchedServer as JServer
from repro.serve.server import Request as JRequest
from repro.serve.server import ServerConfig as JServerConfig
from repro_torch import serve as S
from repro_torch.configs import get_config
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve.server import BatchedServer, Request, ServerConfig


def _model(name, **over):
    jcfg = dataclasses.replace(j_get_config(name).reduced(**over),
                               dtype="float32", remat=False)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    jp = JM.init_params(jcfg, jax.random.PRNGKey(3))
    tp = params_from_numpy(
        tcfg, jax.tree.map(lambda a: np.asarray(a, np.float32), jp),
        device="cpu")
    return jcfg, jp, tcfg, tp


@pytest.fixture(scope="module")
def granite():
    return _model("granite-3-2b")


def _prompt(seed, L, vocab):
    return np.random.RandomState(seed).randint(0, vocab, (L,))


def _greedy(tcfg, tp, prompt, n, max_seq=64, window=0):
    return S.greedy_generate(tcfg, tp, torch.from_numpy(prompt)[None], n,
                             max_seq, window, device="cpu")[0].tolist()


def _server(tcfg, tp, **kw):
    return BatchedServer(tcfg, tp, ServerConfig(**kw), device="cpu")


def test_batched_equals_reference_server_and_sequential(granite):
    jcfg, jp, tcfg, tp = granite
    prompts = [_prompt(i, L, tcfg.vocab_size)
               for i, L in enumerate([5, 9, 7])]
    jsrv = JServer(jcfg, jp, JServerConfig(n_slots=3, max_seq=64))
    want = jsrv.run([JRequest(rid=i, prompt=jnp.asarray(p), max_new=6)
                     for i, p in enumerate(prompts)])
    srv = _server(tcfg, tp, n_slots=3, max_seq=64)
    got = srv.run([Request(rid=i, prompt=p, max_new=6)
                   for i, p in enumerate(prompts)])
    for i, p in enumerate(prompts):
        assert got[i] == [int(t) for t in want[i]]
        assert got[i] == _greedy(tcfg, tp, p, 6)


def test_more_requests_than_slots(granite):
    _, _, tcfg, tp = granite
    prompts = [_prompt(10 + i, 4 + i, tcfg.vocab_size) for i in range(5)]
    srv = _server(tcfg, tp, n_slots=2, max_seq=48)
    out = srv.run([Request(rid=i, prompt=p, max_new=4)
                   for i, p in enumerate(prompts)])
    for i, p in enumerate(prompts):
        assert out[i] == _greedy(tcfg, tp, p, 4, max_seq=48)


def test_encoder_rejected():
    cfg = get_config("hubert-xlarge").reduced()
    with pytest.raises(AssertionError):
        BatchedServer(cfg, {}, ServerConfig(), device="cpu")


# -- slot lifecycle (tests/test_server.py) ----------------------------------


def test_max_new_one_terminates_at_prefill(granite):
    _, _, tcfg, tp = granite
    prompt = _prompt(21, 6, tcfg.vocab_size)
    srv = _server(tcfg, tp, n_slots=2, max_seq=64)
    req = Request(rid=0, prompt=prompt, max_new=1)
    assert srv.submit(req)
    assert req.done and req.out == _greedy(tcfg, tp, prompt, 1)
    assert srv.free_slots() == [0, 1], "prefill-terminated request held a slot"
    assert srv.step() == 0


def test_eos_as_first_token_terminates_at_prefill(granite):
    _, _, tcfg, tp = granite
    prompt = _prompt(22, 5, tcfg.vocab_size)
    eos = _greedy(tcfg, tp, prompt, 1)[0]
    srv = _server(tcfg, tp, n_slots=2, max_seq=64, eos_id=eos)
    req = Request(rid=0, prompt=prompt, max_new=8)
    assert srv.submit(req)
    assert req.done and req.out == [eos]
    assert srv.free_slots() == [0, 1]


def test_slot_reuse_after_eos(granite):
    """A slot freed by a mid-decode EOS is reused at once, and the new
    occupant's stream is untouched by the previous one's cache rows."""
    _, _, tcfg, tp = granite
    p0 = _prompt(23, 5, tcfg.vocab_size)
    p1 = _prompt(24, 7, tcfg.vocab_size)
    ref0, ref1 = _greedy(tcfg, tp, p0, 6), _greedy(tcfg, tp, p1, 4)
    # stop p0 mid-decode at the first token that neither stream had before
    stop = next(i for i in range(1, 6) if ref0[i] not in ref0[:i] + ref1)
    srv = _server(tcfg, tp, n_slots=1, max_seq=64, eos_id=ref0[stop])
    out = srv.run([Request(rid=0, prompt=p0, max_new=8),
                   Request(rid=1, prompt=p1, max_new=4)])
    assert out[0] == ref0[:stop + 1]       # truncated at EOS
    assert out[1] == ref1[:4]              # full, same slot
    assert srv.admitted_order == [0, 1]


def test_full_pool_admission_and_refill_order(granite):
    _, _, tcfg, tp = granite
    prompts = [_prompt(30 + i, 3 + i, tcfg.vocab_size) for i in range(5)]
    max_new = [3, 1, 2, 3, 1]
    srv = _server(tcfg, tp, n_slots=2, max_seq=64)
    out = srv.run([Request(rid=i, prompt=p, max_new=n)
                   for i, (p, n) in enumerate(zip(prompts, max_new))])
    assert srv.admitted_order == [0, 1, 2, 3, 4]
    for i, (p, n) in enumerate(zip(prompts, max_new)):
        assert out[i] == _greedy(tcfg, tp, p, n)
    assert srv.free_slots() == [0, 1]


def test_submit_full_pool_returns_false(granite):
    _, _, tcfg, tp = granite
    srv = _server(tcfg, tp, n_slots=1, max_seq=64)
    p = _prompt(40, 4, tcfg.vocab_size)
    assert srv.submit(Request(rid=0, prompt=p, max_new=5))
    assert not srv.submit(Request(rid=1, prompt=p, max_new=5))


def test_mixed_lengths_bounded_prefill_shapes(granite):
    """Prompts bucket to power-of-two lengths: a second mixed-length pass
    runs no new prefill shape."""
    _, _, tcfg, tp = granite
    srv = _server(tcfg, tp, n_slots=2, max_seq=64, min_bucket=8)
    assert srv.bucketed

    def stream(seed, lengths):
        return [Request(rid=i, prompt=_prompt(seed + i, L, tcfg.vocab_size),
                        max_new=2) for i, L in enumerate(lengths)]
    srv.run(stream(100, [3, 5, 9, 17, 33]))    # buckets 8, 8, 16, 32, 64
    n0 = srv.prefill_compiles()
    assert n0 == 4
    srv.run(stream(200, [4, 7, 11, 20, 40, 6, 15]))
    assert srv.prefill_compiles() == n0


def test_bucketed_prefill_matches_exact(granite):
    _, _, tcfg, tp = granite
    prompt = _prompt(50, 11, tcfg.vocab_size)
    srv = _server(tcfg, tp, n_slots=1, max_seq=64)
    out = srv.run([Request(rid=0, prompt=prompt, max_new=5)])
    assert out[0] == _greedy(tcfg, tp, prompt, 5)
    last, _ = S.make_bucketed_prefill_step(tcfg, 64)(
        tp, {"tokens": torch.from_numpy(S.pad_to_bucket(prompt[None], 16))},
        11)
    exact, _ = S.make_prefill_step(tcfg, 64)(
        tp, {"tokens": torch.from_numpy(prompt[None])})
    torch.testing.assert_close(last, exact, rtol=1e-5, atol=1e-5)


def test_sequence_cap_frees_the_slot(granite):
    """A request stops at max_seq − 1 whatever its max_new, and a prompt
    of max_seq tokens finishes at its prefill."""
    _, _, tcfg, tp = granite
    srv = _server(tcfg, tp, n_slots=1, max_seq=16)
    p = _prompt(60, 10, tcfg.vocab_size)
    out = srv.run([Request(rid=0, prompt=p, max_new=50)])
    assert out[0] == _greedy(tcfg, tp, p, 6, max_seq=16)
    long = Request(rid=1, prompt=_prompt(61, 16, tcfg.vocab_size),
                   max_new=5)
    assert srv.submit(long) and long.done and len(long.out) == 1


def test_ring_window_server_matches_sequential(granite):
    """A window > 0 ring cache: exact-length prefill, and the streams
    equal the windowed sequential generation."""
    _, _, tcfg, tp = granite
    prompts = [_prompt(70 + i, L, tcfg.vocab_size)
               for i, L in enumerate([12, 5])]
    srv = _server(tcfg, tp, n_slots=2, max_seq=64, window=8)
    assert not srv.bucketed
    out = srv.run([Request(rid=i, prompt=p, max_new=6)
                   for i, p in enumerate(prompts)])
    for i, p in enumerate(prompts):
        assert out[i] == _greedy(tcfg, tp, p, 6, window=8)


@pytest.mark.parametrize("name,over", [("rwkv6-3b", {}),
                                       ("zamba2-7b", {"n_layers": 5})])
def test_recurrent_families_prefill_at_exact_length(name, over):
    """ssm and hybrid caches fold every token into their state, so their
    prompts are not padded: one prefill shape per distinct length, and
    the streams equal sequential generation."""
    _, _, tcfg, tp = _model(name, **over)
    srv = _server(tcfg, tp, n_slots=2, max_seq=32)
    assert not srv.bucketed
    lengths = [5, 9, 5]
    prompts = [_prompt(80 + i, L, tcfg.vocab_size)
               for i, L in enumerate(lengths)]
    out = srv.run([Request(rid=i, prompt=p, max_new=4)
                   for i, p in enumerate(prompts)])
    assert srv.prefill_compiles() == len(set(lengths))
    for i, p in enumerate(prompts):
        assert out[i] == _greedy(tcfg, tp, p, 4, max_seq=32)


def test_pow2_bucket_law():
    assert [S.pow2_bucket(n, 8, 64) for n in (1, 8, 9, 33, 64)] == \
        [8, 8, 16, 64, 64]
    with pytest.raises(ValueError):
        S.pow2_bucket(0)
    with pytest.raises(ValueError):
        S.pow2_bucket(65, 8, 64)
    t = torch.arange(1, 4)[None]
    assert S.pad_to_bucket(t, 8).tolist() == [[1, 2, 3, 0, 0, 0, 0, 0]]
    with pytest.raises(ValueError):
        S.pad_to_bucket(t, 2)


def test_entry_points_default_to_cuda(granite):
    _, _, tcfg, tp = granite
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchedServer(tcfg, tp, ServerConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        S.greedy_generate(tcfg, tp, torch.zeros((1, 3), dtype=torch.long),
                          2, 8)
