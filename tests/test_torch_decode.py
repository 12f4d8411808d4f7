"""The port's forward, KV and recurrent caches and decode step against the
JAX package.

The reference's ``init_params`` weights are carried into the port
(``models.convert.params_from_numpy``).  Logits are held to 2e-3
(``tests/test_archs.py::test_decode_matches_full_forward``), f32
throughout, on ``reduced()`` configs: granite-3-2b (dense), rwkv6-3b
(ssm) and zamba2-7b (hybrid, 5 layers with ``attn_every = 2``: two uses
of the shared block, each with its own KV cache, and a 1-layer tail).
The JAX runs live in module-scoped fixtures: each shape is a compile.
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
from repro_torch import serve as S
from repro_torch.configs import ARCHS, get_config
from repro_torch.kernels import attention_cached as CA
from repro_torch.kernels import checks, ref
from repro_torch.models import layers
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_numpy

TOL = 2e-3
REDUCED = {"granite-3-2b": {}, "rwkv6-3b": {}, "zamba2-7b": {"n_layers": 5}}
B, SP = 2, 13                    # batch, prompt length


def _cfgs(name, **over):
    ref_cfg = dataclasses.replace(
        j_get_config(name).reduced(**over), dtype="float32", remat=False)
    return ref_cfg, ModelConfig(**dataclasses.asdict(ref_cfg))


def _carried(jcfg, tcfg, seed=3):
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jparams)
    return jparams, params_from_numpy(tcfg, tree, device="cpu")


@pytest.fixture(scope="module", params=sorted(REDUCED))
def model(request):
    """(name, jax cfg, port cfg, jax params, port params, tokens, JAX full
    logits over SP + 1 tokens, JAX prefill + decode logits)."""
    name = request.param
    jcfg, tcfg = _cfgs(name, **REDUCED[name])
    jp, tp = _carried(jcfg, tcfg)
    tokens = np.random.RandomState(7).randint(0, tcfg.vocab_size,
                                              (B, SP + 1))
    full, _, _ = JM.forward(jcfg, jp, {"tokens": jnp.asarray(tokens)})
    _, cache = JS.make_prefill_step(jcfg, SP + 1)(
        jp, {"tokens": jnp.asarray(tokens[:, :SP])})
    dec, _ = JS.make_decode_step(jcfg)(jp, cache, jnp.asarray(tokens[:, SP:]),
                                       jnp.asarray(SP, jnp.int32))
    return name, jcfg, tcfg, jp, tp, tokens, np.asarray(full), np.asarray(dec)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_forward_logits_match_the_reference(model):
    name, _, tcfg, _, tp, tokens, full, _ = model
    logits, aux, cache = M.forward(tcfg, tp, {"tokens": _t(tokens)})
    assert logits.dtype == torch.float32
    assert logits.shape == (B, SP + 1, tcfg.vocab_size)
    assert float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), full, rtol=TOL, atol=TOL)
    if tcfg.family == "dense":
        assert cache is None


def test_prefill_then_decode_matches_the_full_forward(model):
    """prefill(S) + decode(1) ≡ forward(S + 1) at the last position, in
    the port and against the reference's decode."""
    name, _, tcfg, _, tp, tokens, full, dec = model
    prefill = S.make_prefill_step(tcfg, SP + 1)
    decode = S.make_decode_step(tcfg)
    last, cache = prefill(tp, {"tokens": _t(tokens[:, :SP])})
    np.testing.assert_allclose(last.numpy(), full[:, SP - 1], rtol=TOL,
                               atol=TOL)
    got, _ = decode(tp, cache, _t(tokens[:, SP:]), SP)
    np.testing.assert_allclose(got.numpy(), full[:, -1], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), dec, rtol=TOL, atol=TOL)


def test_cache_layout_matches_the_reference(model):
    """init_cache's leaves have the reference's shapes and dtypes (slot
    axis 1 everywhere), and a prefill writes the same KV / state."""
    name, jcfg, tcfg, jp, tp, tokens, _, _ = model
    jcache = JM.init_cache(jcfg, B, SP + 1)
    tcache = M.init_cache(tcfg, B, SP + 1, device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(jcache)[0]
    for path, leaf in flat:
        node = tcache
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape, path
    _, jc = JS.make_prefill_step(jcfg, SP + 1)(
        jp, {"tokens": jnp.asarray(tokens[:, :SP])})
    _, tc = S.make_prefill_step(tcfg, SP + 1)(
        tp, {"tokens": _t(tokens[:, :SP])})
    for path, leaf in jax.tree_util.tree_flatten_with_path(jc)[0]:
        node = tc
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(node.float().numpy(),
                                   np.asarray(leaf, np.float32), rtol=TOL,
                                   atol=TOL, err_msg=str(path))


def test_per_row_positions_equal_each_row_alone(model):
    """One decode over rows at different positions (the server's slots)
    equals each row prefilled and decoded on its own."""
    _, _, tcfg, _, tp, tokens, _, _ = model
    lengths = (5, 11)
    prefill = S.make_prefill_step(tcfg, SP + 1)
    decode = S.make_decode_step(tcfg)
    alone, caches = [], []
    for b, L in enumerate(lengths):
        _, c = prefill(tp, {"tokens": _t(tokens[b:b + 1, :L])})
        caches.append(c)
        nxt = _t(tokens[b:b + 1, L:L + 1])
        lg, _ = decode(tp, {k: _clone(v) for k, v in c.items()}, nxt, L)
        alone.append(lg)
    both = {k: _cat(caches[0][k], caches[1][k]) for k in caches[0]}
    nxt = _t(np.stack([tokens[b, L] for b, L in enumerate(lengths)]))[:, None]
    got, _ = decode(tp, both, nxt, np.asarray(lengths))
    np.testing.assert_allclose(got.numpy(), torch.cat(alone).numpy(),
                               rtol=1e-5, atol=1e-5)


def _clone(v):
    return {k: _clone(x) for k, x in v.items()} if isinstance(v, dict) \
        else v.clone()


def _cat(a, b):
    if isinstance(a, dict):
        return {k: _cat(a[k], b[k]) for k in a}
    return torch.cat([a, b], dim=1)


@pytest.fixture(scope="module")
def yi():
    """yi-34b reduced with a ring of W = 8 over S = 21 tokens (the
    reference's ``test_sliding_window_ring_buffer``)."""
    jcfg, tcfg = _cfgs("yi-34b")
    jp, tp = _carried(jcfg, tcfg, seed=0)
    W, Sy = 8, 21
    tokens = np.random.RandomState(0).randint(0, tcfg.vocab_size, (1, Sy + 1))
    full, _, _ = JM.forward(jcfg, jp, {"tokens": jnp.asarray(tokens)},
                            window=W)
    _, jc = JS.make_prefill_step(jcfg, Sy + 1, window=W)(
        jp, {"tokens": jnp.asarray(tokens[:, :Sy])})
    dec, _ = JS.make_decode_step(jcfg, window=W)(
        jp, jc, jnp.asarray(tokens[:, Sy:]), jnp.asarray(Sy, jnp.int32))
    return (tcfg, tp, tokens, W, Sy, np.asarray(full), jax.tree.map(
        lambda a: np.asarray(a, np.float32), jc), np.asarray(dec))


def test_ring_buffer_decode_matches_the_reference(yi):
    tcfg, tp, tokens, W, Sy, full, _, dec = yi
    _, cache = S.make_prefill_step(tcfg, Sy + 1, window=W)(
        tp, {"tokens": _t(tokens[:, :Sy])})
    assert cache["k"].shape[2] == W      # a ring, not the full length
    got, _ = S.make_decode_step(tcfg, window=W)(tp, cache,
                                                _t(tokens[:, Sy:]), Sy)
    np.testing.assert_allclose(got.numpy(), dec, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), full[:, -1], rtol=TOL, atol=TOL)
    # the windowed full forward itself
    logits, _, _ = M.forward(tcfg, tp, {"tokens": _t(tokens)}, window=W)
    np.testing.assert_allclose(logits.numpy(), full, rtol=TOL, atol=TOL)


def test_ring_chunk_write_keeps_the_last_tokens(yi):
    """A chunk of S > W tokens leaves the ring holding its last W tokens,
    as the reference's duplicate-slot scatter ("last wins") does."""
    tcfg, tp, tokens, W, Sy, _, jcache, _ = yi
    _, cache = S.make_prefill_step(tcfg, Sy + 1, window=W)(
        tp, {"tokens": _t(tokens[:, :Sy])})
    for k in ("k", "v"):
        np.testing.assert_allclose(cache[k].numpy(), jcache[k], rtol=TOL,
                                   atol=TOL)
    # slot j holds position p with p % W == j among the last W positions
    pos = layers.Positions.of(None, 1, Sy, "cpu")
    slots = torch.remainder(pos.q[0, -W:], W)
    assert sorted(slots.tolist()) == list(range(W))


def test_ring_chunks_continue_a_ring(yi):
    """Two ring chunks (13 then 8 tokens, the second starting mid-ring)
    give the single 21-token prefill's decode logits."""
    tcfg, tp, tokens, W, Sy, full, _, _ = yi
    cache = M.init_cache(tcfg, 1, Sy + 1, W, device="cpu")
    M.forward(tcfg, tp, {"tokens": _t(tokens[:, :13])}, cache=cache,
              window=W, use_cache=True)
    M.forward(tcfg, tp, {"tokens": _t(tokens[:, 13:Sy])}, cache=cache,
              positions=13, window=W, use_cache=True)
    got, _ = S.make_decode_step(tcfg, window=W)(tp, cache,
                                                _t(tokens[:, Sy:]), Sy)
    np.testing.assert_allclose(got.numpy(), full[:, -1], rtol=TOL, atol=TOL)


def test_prefill_routes_agree():
    """A dense prefill at a host-known start takes the flash route; the
    same chunk with per-row start positions takes the cached-attention
    route.  Both give the same logits and cache (layer 0's keys bit for
    bit: they precede any attention)."""
    _, tcfg = _cfgs("granite-3-2b")
    g = torch.Generator()
    g.manual_seed(0)
    tp = M.init_params(tcfg, g, device="cpu")
    tok = torch.randint(0, tcfg.vocab_size, (2, 9), generator=g)
    outs = []
    for pos in (4, torch.arange(4, 9).expand(2, 5)):
        cache = M.init_cache(tcfg, 2, 16, device="cpu")
        M.forward(tcfg, tp, {"tokens": tok[:, :4]}, cache=cache,
                  use_cache=True)
        lg, _, cache = M.forward(tcfg, tp, {"tokens": tok[:, 4:]},
                                 cache=cache, positions=pos, use_cache=True)
        outs.append((lg, cache["k"]))
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(outs[0][1][0], outs[1][1][0], rtol=0, atol=0)
    torch.testing.assert_close(outs[0][1], outs[1][1], rtol=1e-5, atol=1e-5)


def test_dense_cache_overflow_raises():
    """The reference's dynamic_update_slice clamps a write past the cache;
    the port raises."""
    _, tcfg = _cfgs("granite-3-2b")
    g = torch.Generator()
    g.manual_seed(0)
    tp = M.init_params(tcfg, g, device="cpu")
    cache = M.init_cache(tcfg, 2, 8, device="cpu")
    tok = torch.zeros((2, 1), dtype=torch.long)
    with pytest.raises(ValueError, match="overflow"):
        M.forward(tcfg, tp, {"tokens": tok}, cache=cache,
                  positions=np.asarray([3, 8]), use_cache=True)
    with pytest.raises(ValueError, match="overflow"):
        M.forward(tcfg, tp, {"tokens": torch.zeros((2, 9), dtype=torch.long)},
                  cache=cache, use_cache=True)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 3),
                                           (False, 0)])
def test_positions_ref_matches_the_reference_sdpa(causal, window):
    """``ref.attention_positions_ref`` against the reference's
    ``_sdpa_chunked`` with ``kv_positions`` / ``kv_valid``, on a ring's
    key positions (wrapped, some slots empty) and GQA."""
    from repro.models.layers import _sdpa_chunked
    rs = np.random.RandomState(1)
    Bq, H, Hkv, Sq, Sk, D = 1, 4, 2, 3, 8, 16
    q = rs.randn(Bq, Sq, H, D).astype(np.float32)
    k = rs.randn(Bq, Sk, Hkv, D).astype(np.float32)
    v = rs.randn(Bq, Sk, Hkv, D).astype(np.float32)
    q_pos = np.asarray([9, 10, 11])
    kv_pos = np.asarray([8, 9, 10, 11, 4, 5, -1, 7])
    exp = _sdpa_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=causal, window=window,
                        q_positions=jnp.asarray(q_pos),
                        kv_positions=jnp.asarray(kv_pos),
                        kv_valid=jnp.asarray(kv_pos >= 0))
    got = ref.attention_positions_ref(
        _t(q).transpose(1, 2), _t(k).transpose(1, 2), _t(v).transpose(1, 2),
        _t(q_pos)[None], _t(kv_pos)[None], causal=causal, window=window)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), np.asarray(exp),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_sm", [1, 132])
@pytest.mark.parametrize("tag", sorted(checks.CACHED_CASES))
def test_split_plan_covers_the_keys_in_whole_tiles(tag, n_sm):
    """Each check case's key ranges are whole 64-key tiles, none empty,
    covering every key.  On one SM nothing splits; at the H100's 132 the
    ring cases (a wrapped ring and a chunk: under five tiles; the ring
    server's prefill: a grid that fills the card) run unsplit (the
    kernel's branch that writes the output from the block) and every
    decode over a ragged cache splits (the combine pass): the chip
    smoke's cases hold both branches."""
    B, H, Hkv, Sq, Sk, D, window, kind = checks.CACHED_CASES[tag]
    n_keys = Sk + Sq if kind in ("chunk", "prefill") else Sk
    per, n_split = CA.split_plan(B, H, Hkv, Sq, n_keys, n_sm)
    assert per % CA.BK == 0 and n_split >= 1
    assert (n_split - 1) * per < n_keys <= n_split * per
    assert (n_split == 1) == (n_sm == 1 or kind != "ragged")


def test_configs_match_reference():
    for name in ("granite-3-2b", "yi-34b"):
        assert dataclasses.asdict(get_config(name)) == \
            dataclasses.asdict(j_get_config(name))
    assert {"granite-3-2b", "yi-34b"} <= set(ARCHS)
