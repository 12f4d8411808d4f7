"""The moe, vlm and relu2 families and the five configs that bring them
(granite-moe-3b-a800m, grok-1-314b, pixtral-12b, nemotron-4-340b,
granite-34b) against the JAX package, ``reduced()``.

The reference's weights are carried into the port
(``models.convert.params_from_numpy``).  ``forward``'s logits and aux loss
and ``features`` are held to 1e-4 in f32 and 3e-2 in bf16, where the two
frameworks round activations to bf16 at different places
(``tests/test_torch_backbones.py``); prefill + decode to 2e-3
(``tests/test_archs.py::test_decode_matches_full_forward``), with the MoE
configs dropless (``capacity_factor = 8``) as that test runs them.
granite-moe is cut to 16 experts so that its top-8 routing chooses; the
vlm runs with its image prefix (``batch["img"]``).  The JAX runs are
jitted and live in module-scoped fixtures.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serve as JS
from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_config as j_get_config
from repro.models import model as JM
from repro.serve import server as JSV
from repro_torch import serve as S
from repro_torch.configs import ARCHS, get_config
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import server as SV

NEW = {"granite-moe-3b-a800m": {"n_experts": 16}, "grok-1-314b": {},
       "pixtral-12b": {}, "nemotron-4-340b": {}, "granite-34b": {}}
TOL = 2e-3
B, SP = 2, 13                    # batch, prompt length


def _cfgs(name, **over):
    ref = dataclasses.replace(j_get_config(name).reduced(**NEW[name]),
                              remat=False, **over)
    return ref, ModelConfig(**dataclasses.asdict(ref))


def _carried(jcfg, tcfg, seed=3):
    jparams = jax.jit(JM.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(seed))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jparams)
    return jparams, params_from_numpy(tcfg, tree, device="cpu")


def _batch(cfg, tokens, seed=0):
    """Token ids, and for the vlm its image-prefix embeddings."""
    b = {"tokens": tokens}
    if cfg.family == "vlm":
        b["img"] = np.random.RandomState(seed).randn(
            tokens.shape[0], cfg.n_img_tokens,
            cfg.img_embed_dim).astype(np.float32)
    return b


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.fixture(scope="module", params=sorted(NEW))
def model(request):
    """(name, port cfg, port params, batch over SP + 1 tokens, JAX full
    logits, aux and features, JAX prefill + decode logits), f32."""
    name = request.param
    jcfg, tcfg = _cfgs(name, dtype="float32", capacity_factor=8.0)
    jp, tp = _carried(jcfg, tcfg)
    tokens = np.random.RandomState(7).randint(0, tcfg.vocab_size,
                                              (B, SP + 1))
    full = _batch(tcfg, tokens)
    logits, aux, _ = jax.jit(JM.forward, static_argnums=0)(jcfg, jp,
                                                           _j(full))
    feats = jax.jit(JM.features, static_argnums=0)(jcfg, jp, _j(full))
    n_img = M.n_img(tcfg)
    prompt = dict(full, tokens=tokens[:, :SP])
    _, cache = jax.jit(JS.make_prefill_step(jcfg, SP + 1 + n_img))(
        jp, _j(prompt))
    dec, _ = jax.jit(JS.make_decode_step(jcfg))(
        jp, cache, jnp.asarray(tokens[:, SP:]),
        jnp.asarray(SP + n_img, jnp.int32))
    return (name, tcfg, tp, full, np.asarray(logits), float(aux),
            np.asarray(feats), np.asarray(dec))


def test_forward_logits_aux_and_features_match_the_reference(model):
    name, tcfg, tp, full, logits, aux, feats, _ = model
    got, got_aux, cache = M.forward(tcfg, tp, _t(full))
    S_out = SP + 1 + M.n_img(tcfg)
    assert got.shape == (B, S_out, tcfg.vocab_size) and cache is None
    np.testing.assert_allclose(got.numpy(), logits, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(got_aux), aux, rtol=1e-4, atol=1e-7)
    assert (aux > 0) == bool(tcfg.n_experts)
    f = M.features(tcfg, tp, full, device="cpu")
    np.testing.assert_allclose(f.numpy(), feats, rtol=1e-4, atol=1e-4)


def test_prefill_then_decode_matches_the_reference(model):
    """prefill(S) + decode(1) ≡ the reference's prefill + decode and the
    full forward at the last position; a vlm prompt is its image and
    then its text, and the decoded token sits at n_img + S."""
    name, tcfg, tp, full, logits, _, _, dec = model
    n_img = M.n_img(tcfg)
    prompt = _t(dict(full, tokens=full["tokens"][:, :SP]))
    last, cache = S.make_prefill_step(tcfg, SP + 1 + n_img)(tp, prompt)
    np.testing.assert_allclose(last.numpy(), logits[:, -2], rtol=TOL,
                               atol=TOL)
    got, _ = S.make_decode_step(tcfg)(
        tp, cache, torch.from_numpy(full["tokens"][:, SP:]), SP + n_img)
    np.testing.assert_allclose(got.numpy(), dec, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), logits[:, -1], rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("name", sorted(NEW))
def test_bf16_forward_and_features_match_the_reference(name):
    """At each config's own capacity factor, in bf16.  The reference is
    compiled without XLA's excess precision, so that it rounds to bf16
    where its code casts, as its eager run and the port do: by default
    XLA keeps f32 across fused bf16 casts, and the jitted reference then
    leaves its own eager run by 0.18 in granite-moe's logits."""
    jcfg, tcfg = _cfgs(name)
    jp, tp = _carried(jcfg, tcfg, seed=5)
    tokens = np.random.RandomState(5).randint(0, tcfg.vocab_size, (B, 16))
    batch = _batch(tcfg, tokens, seed=5)

    def ref(p, b):
        return JM.forward(jcfg, p, b)[:2], JM.features(jcfg, p, b)
    (logits, aux), feats = jax.jit(ref).lower(jp, _j(batch)).compile(
        compiler_options={"xla_allow_excess_precision": False})(
            jp, _j(batch))
    got, got_aux, _ = M.forward(tcfg, tp, _t(batch))
    np.testing.assert_allclose(got.numpy(), np.asarray(logits), rtol=3e-2,
                               atol=3e-2)
    np.testing.assert_allclose(float(got_aux), float(aux), rtol=3e-2)
    f = M.features(tcfg, tp, batch, device="cpu")
    np.testing.assert_allclose(f.numpy(), np.asarray(feats), rtol=3e-2,
                               atol=3e-2)


def test_configs_match_reference():
    """All ten architectures, field for field."""
    assert sorted(ARCHS) == sorted(J_ARCHS)
    for name in J_ARCHS:
        assert dataclasses.asdict(get_config(name)) == \
            dataclasses.asdict(j_get_config(name))


def test_batched_server_streams_match_the_reference():
    """granite-moe in f32 at its own capacity factor: the port's server
    (bucketed prefill, one decode over the slots with each slot its own
    MoE group) gives the reference's server's token streams (bucketed
    prefill, a ``vmap``ped one-row decode)."""
    jcfg, tcfg = _cfgs("granite-moe-3b-a800m", dtype="float32")
    jp, tp = _carried(jcfg, tcfg, seed=1)
    rs = np.random.RandomState(1)
    prompts = [rs.randint(1, tcfg.vocab_size, (L,)) for L in (5, 11, 3, 9)]
    scfg = dict(n_slots=3, max_seq=32)
    jsrv = JSV.BatchedServer(jcfg, jp, JSV.ServerConfig(**scfg))
    want = jsrv.run([JSV.Request(rid=i, prompt=jnp.asarray(p), max_new=6)
                     for i, p in enumerate(prompts)])
    tsrv = SV.BatchedServer(tcfg, tp, SV.ServerConfig(**scfg), device="cpu")
    with L.record_moe() as rec:
        got = tsrv.run([SV.Request(rid=i, prompt=p, max_new=6)
                        for i, p in enumerate(prompts)])
    assert got == {k: [int(t) for t in v] for k, v in want.items()}
    # the decode steps group per row (cap = K): none of theirs drops
    decode = [int(d) for _, d, per_row in rec if per_row]
    assert decode and sum(decode) == 0
    assert tsrv.admitted_order == jsrv.admitted_order


def test_vlm_without_an_image_raises_on_both_sides():
    """The reference's prefill puts a vlm's text at n_img … and fails on a
    prompt without an image; the port refuses it with a ValueError, in
    ``greedy_generate`` and the server's ``submit``."""
    jcfg, tcfg = _cfgs("pixtral-12b", dtype="float32", n_layers=1)
    jp, tp = _carried(jcfg, tcfg)
    prompt = np.arange(1, 7)[None]
    with pytest.raises((ValueError, TypeError)):
        JS.greedy_generate(jcfg, jp, jnp.asarray(prompt), 2, 32)
    with pytest.raises(ValueError, match="img"):
        S.greedy_generate(tcfg, tp, torch.from_numpy(prompt), 2, 32,
                          device="cpu")
    srv = SV.BatchedServer(tcfg, tp, SV.ServerConfig(n_slots=2, max_seq=32),
                           device="cpu")
    with pytest.raises(ValueError, match="img"):
        srv.submit(SV.Request(rid=0, prompt=prompt[0], max_new=2))


def test_padded_moe_feature_batch_moves_a_real_row():
    """A fault of the reference, mirrored: ``make_feature_step`` promises
    that pads never influence real positions, but a MoE group spans rows,
    so row 0's pads take capacity slots ahead of row 1's real tokens.
    Changing only row 0's pad ids moves row 1's features, by the same
    amount on both sides."""
    jcfg, tcfg = _cfgs("grok-1-314b", dtype="float32")
    jp, tp = _carried(jcfg, tcfg, seed=2)
    rs = np.random.RandomState(2)
    tokens = rs.randint(1, tcfg.vocab_size, (2, 32))
    length = np.asarray([8, 32])
    other = tokens.copy()
    tokens[0, 8:] = 0                       # pad_to_bucket's pads
    other[0, 8:] = 5
    jf = jax.jit(JS.make_feature_step(jcfg))
    tf = S.make_feature_step(tcfg)
    rows = {}
    for tag, tok in (("pads", tokens), ("other", other)):
        want = np.asarray(jf(jp, jnp.asarray(tok), jnp.asarray(length)))
        with L.record_moe() as rec:
            got = tf(tp, torch.from_numpy(tok),
                     torch.from_numpy(length)).numpy()
        assert sum(int(d) for _, d, _ in rec) > 0
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        rows[tag] = (got, want)
    moved_t = rows["pads"][0][1] - rows["other"][0][1]
    moved_j = rows["pads"][1][1] - rows["other"][1][1]
    assert np.abs(moved_j).max() > 1e-2
    np.testing.assert_allclose(moved_t, moved_j, rtol=1e-3, atol=1e-4)
