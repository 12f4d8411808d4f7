"""The port's mixture of experts (``models/layers.py::moe``) against the JAX
package's ``moe`` on the same inputs and carried weights, in f32.

Outputs are held to 1e-5: both sides sum the same K weighted expert
outputs per token in f32, in another order.  The cases: (a) dropless, (b)
``capacity_factor = 0.5``, where assignments are dropped, (c) experts with
tied router probabilities (``lax.top_k`` keeps the lower expert first and
the order of a token's K choices feeds the capacity slots), (d) a token
count that no group size divides (one group of all tokens), then the
per-row groups of the server's decode against the reference's ``vmap`` of
``moe`` over rows, and the aux loss.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_numpy

TOL = 1e-5


def _cfgs(name="grok-1-314b", **over):
    """f32 configs of one MoE architecture, ``reduced`` to d_model 64 and
    8 experts (grok-1: top-2, GELU; granite-moe: top-8, SwiGLU)."""
    ref = dataclasses.replace(
        j_get_config(name).reduced(d_model=64, n_experts=8 if name ==
                                   "grok-1-314b" else 16),
        dtype="float32", **over)
    return ref, ModelConfig(**dataclasses.asdict(ref))


def _weights(cfg, seed=0, tie=False):
    """One layer's MoE weights in ``init_moe``'s law, drawn with numpy."""
    rs = np.random.RandomState(seed)
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts

    def dense(*shape):
        return (rs.randn(*shape) / np.sqrt(shape[-2])).astype(np.float32)
    w = {"router": dense(d, E), "we_in": dense(E, d, ff),
         "we_out": dense(E, ff, d)}
    if cfg.mlp_variant == "swiglu":
        w["we_gate"] = dense(E, d, ff)
    if tie:
        # three experts with an all-zero router column score exactly 0;
        # the others are scaled down so that the tied three often meet at
        # a token's K-th choice
        w["router"] *= 0.02
        w["router"][:, [1, 4, 5]] = 0.0
    return w


# one compile per shape, not one per operation
_jmoe = jax.jit(JL.moe, static_argnums=(2, 3))


def _run(jcfg, tcfg, w, x, group_size=1024):
    """(JAX y, JAX aux, port y, port aux, port drops)."""
    jy, jaux = _jmoe(jnp.asarray(x), {k: jnp.asarray(v) for k, v in
                                      w.items()}, jcfg, group_size)
    with L.record_moe() as rec:
        ty, taux = L.moe(torch.from_numpy(x), {k: torch.from_numpy(v)
                                               for k, v in w.items()},
                         tcfg, group_size=group_size)
    return (np.asarray(jy), float(jaux), ty.numpy(), float(taux),
            sum(int(d) for _, d, _ in rec))


def _x(shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("name", ["grok-1-314b", "granite-moe-3b-a800m"])
@pytest.mark.parametrize("case", ["dropless", "drops", "ties", "ragged"])
def test_moe_matches_the_reference(name, case):
    cf = {"dropless": 8.0, "drops": 0.5}.get(case, 1.25)
    jcfg, tcfg = _cfgs(name, capacity_factor=cf)
    w = _weights(jcfg, tie=case == "ties")
    B, S = (3, 20) if case == "ragged" else (4, 32)
    x = _x((B, S, jcfg.d_model))
    jy, jaux, ty, taux, drops = _run(jcfg, tcfg, w, x, group_size=32)
    np.testing.assert_allclose(ty, jy, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(taux, jaux, rtol=TOL, atol=1e-7)
    if case == "dropless":
        assert drops == 0
    if case == "drops":
        assert drops > 0
    if case == "ties":
        probs = torch.softmax(torch.from_numpy(x.reshape(-1, jcfg.d_model))
                              @ torch.from_numpy(w["router"]), -1)
        kth = torch.sort(probs, -1, descending=True).values[:, tcfg.top_k - 1]
        nxt = torch.sort(probs, -1, descending=True).values[:, tcfg.top_k]
        assert int((kth == nxt).sum()) > 0    # ties at the K-th choice


def test_tied_experts_keep_the_lower_index_first():
    """The stable descending sort is ``lax.top_k``'s order under ties."""
    p = np.asarray([[0.1, 0.3, 0.3, 0.2, 0.3, 0.1]], np.float32)
    jw, ji = jax.lax.top_k(jnp.asarray(p), 4)
    tw, ti = torch.sort(torch.from_numpy(p), dim=-1, descending=True,
                        stable=True)
    assert ti[:, :4].tolist() == np.asarray(ji).tolist() == [[1, 2, 4, 3]]


@pytest.mark.parametrize("name", ["grok-1-314b", "granite-moe-3b-a800m"])
@pytest.mark.parametrize("S", [1, 6])
def test_per_row_groups_equal_the_reference_vmap(name, S):
    """``per_row`` makes each row its own group: the reference's server
    ``vmap``s a one-row decode over its slots.  At 8 slots of one token
    all grouped together, grok-1's capacity would be 3 for 16
    assignments; per row it is K and nothing drops."""
    jcfg, tcfg = _cfgs(name)
    w = _weights(jcfg)
    x = _x((8, S, jcfg.d_model), seed=S)
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    jy = jax.jit(jax.vmap(lambda r: JL.moe(r[None], jw, jcfg)[0][0]))(
        jnp.asarray(x))
    with L.record_moe() as rec:
        ty, _ = L.moe(torch.from_numpy(x), {k: torch.from_numpy(v)
                                            for k, v in w.items()}, tcfg,
                      per_row=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=TOL,
                               atol=TOL)
    assert rec and all(per_row for _, _, per_row in rec)
    if S == 1:
        assert sum(int(d) for _, d, _ in rec) == 0
        # the same tokens as one group drop assignments (grok-1) or not
        with L.record_moe() as rec:
            L.moe(torch.from_numpy(x), {k: torch.from_numpy(v)
                                        for k, v in w.items()}, tcfg)
        pooled = sum(int(d) for _, d, _ in rec)
        assert (pooled > 0) == (name == "grok-1-314b"), pooled


def test_aux_loss_matches_the_reference_and_its_formula():
    """aux = E · Σ_e frac_tokens_e · frac_probs_e · router_aux_coef over
    all tokens, whatever the groups."""
    jcfg, tcfg = _cfgs(router_aux_coef=0.03)
    w = _weights(jcfg, seed=5)
    x = _x((2, 48, jcfg.d_model), seed=5)
    _, jaux, _, taux, _ = _run(jcfg, tcfg, w, x, group_size=16)
    np.testing.assert_allclose(taux, jaux, rtol=TOL)
    probs = torch.softmax(torch.from_numpy(x.reshape(-1, jcfg.d_model))
                          @ torch.from_numpy(w["router"]), -1)
    top = torch.topk(probs, tcfg.top_k, -1).indices
    frac_tokens = torch.stack([(top == e).sum() for e in
                               range(tcfg.n_experts)]).float() / top.numel()
    want = tcfg.n_experts * float((frac_tokens * probs.mean(0)).sum()) * 0.03
    np.testing.assert_allclose(taux, want, rtol=TOL)
    _, taux_rows = L.moe(torch.from_numpy(x), {k: torch.from_numpy(v)
                                                for k, v in w.items()},
                         tcfg, per_row=True)
    np.testing.assert_allclose(float(taux_rows), taux, rtol=TOL)


def test_bf16_moe_keeps_an_f32_router():
    """Under a bf16 config the router stays f32 (drawn and carried), the
    experts take bf16, and the layer's output is bf16."""
    jcfg, tcfg = _cfgs()
    jcfg = dataclasses.replace(jcfg, dtype="bfloat16", n_layers=1)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    g = torch.Generator()
    g.manual_seed(0)
    drawn = M.init_params(tcfg, g, device="cpu")
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        JM.init_params(jcfg, jax.random.PRNGKey(0)))
    carried = params_from_numpy(tcfg, tree, device="cpu")
    for p in (drawn, carried):
        assert p["blocks"]["router"].dtype == torch.float32
        for k in ("we_in", "we_out", "wq"):
            assert p["blocks"][k].dtype == torch.bfloat16
    x = torch.randn(2, 5, tcfg.d_model, generator=g).to(torch.bfloat16)
    y, aux = L.moe(x, {k: v[0] for k, v in drawn["blocks"].items()}, tcfg)
    assert y.dtype == torch.bfloat16 and aux.dtype == torch.float32

