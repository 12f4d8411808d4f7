"""The port's ``launch/`` modules against ``repro/launch/``: the sharding
rules, the input and cache shapes, the pair rules, ``active_params`` /
``model_flops_for`` (all exact, every config), the operation count
against ``HloCost`` (dot FLOPs exact on reduced forwards and a gradient;
granite-moe's gap named and sized), and the dry-run CLIs at a small size.
"""
import contextlib
import dataclasses
import io
import json
import math

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import ARCHS
from repro.configs import get_config as jax_config
from repro.launch import input_specs as JI
from repro.launch import roofline as JR
from repro.launch import sharding as JS
from repro.launch.hlo_cost import HloCost
from repro.models import model as JM
from repro.models.config import INPUT_SHAPES as JSHAPES
from repro.optim import adam as jax_adam
from repro_torch import optim, train
from repro_torch.configs import get_config
from repro_torch.kernels import checks, ops, ref
from repro_torch.launch import dryrun as DR
from repro_torch.launch import fedpft_dryrun as FD
from repro_torch.launch import hlo_cost as HC
from repro_torch.launch import input_specs as I
from repro_torch.launch import roofline as R
from repro_torch.launch import sharding as S
from repro_torch.models import model as M
from repro_torch.models.config import INPUT_SHAPES


class FakeMesh2D:
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


class FakeMesh3D:
    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 16, "model": 16}


def _jax_flat(tree):
    """'/'-joined path → leaf (a PartitionSpec as its tuple)."""
    P = jax.sharding.PartitionSpec
    out = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, P))[0]:
        path = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in kp)
        out[path] = tuple(leaf) if isinstance(leaf, P) else leaf
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, path))
        else:
            out[path] = v
    return out


def _shapes(flat):
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in flat.items()}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_specs_and_shapes_equal_the_reference(arch):
    """For one config: parameter shapes and dtypes, the parameter and
    optimizer specs on both production meshes, every shape's batch
    specs, pair rules and window, every decode shape's cache shapes and
    cache specs, ``active_params`` and ``model_flops_for`` — all equal."""
    jc, tc = jax_config(arch), get_config(arch)
    jp, tp = JI.params_shapes(jc), I.params_shapes(tc)
    assert _shapes(_flat(tp)) == {k: (tuple(v.shape), str(v.dtype))
                                  for k, v in _jax_flat(jp).items()}
    j_opt = jax.eval_shape(jax_adam(1e-4).init, jp)
    t_opt = optim.adam(1e-4).init(tp)
    for mesh in (FakeMesh2D(), FakeMesh3D()):
        j_spec = JS.param_specs(jc, jp, mesh)
        t_spec = S.param_specs(tc, tp, mesh)
        assert _flat(t_spec) == _jax_flat(j_spec)
        assert _flat(S.opt_specs(t_spec, t_opt)) == \
            _jax_flat(JS.opt_specs(j_spec, j_opt))
    assert R.active_params(tc) == JR.active_params(jc)
    for name in INPUT_SHAPES:
        jsh, tsh = JSHAPES[name], INPUT_SHAPES[name]
        assert I.pair_supported(tc, tsh) == JI.pair_supported(jc, jsh)
        assert I.window_for(tc, tsh) == JI.window_for(jc, jsh)
        assert I.mode_of(tc, tsh) == JI.mode_of(jc, jsh)
        if not I.pair_supported(tc, tsh)[0]:
            continue
        assert R.model_flops_for(tc, tsh, tsh.kind) == \
            JR.model_flops_for(jc, jsh, jsh.kind)
        for mode in ("train", "prefill", "decode"):
            jb = JI.batch_specs_for(jc, jsh, mode)
            tb = I.batch_specs_for(tc, tsh, mode)
            assert {k: (s, str(d).replace("torch.", ""))
                    for k, (s, d) in tb.items()} == \
                {k: (v.shape, str(v.dtype)) for k, v in jb.items()}
            for mesh in (FakeMesh2D(), FakeMesh3D()):
                assert S.batch_specs(tb, mesh) == \
                    _jax_flat(JS.batch_specs(jb, mesh))
        if tsh.kind == "decode":
            jcache, tcache = JI.cache_shapes(jc, jsh), I.cache_shapes(tc, tsh)
            assert _shapes(_flat(tcache)) == {
                k: (tuple(v.shape), str(v.dtype))
                for k, v in _jax_flat(jcache).items()}
            for mesh in (FakeMesh2D(), FakeMesh3D()):
                assert _flat(S.cache_specs(tcache, mesh)) == \
                    _jax_flat(JS.cache_specs(jcache, mesh))


def test_activation_specs_and_constraint():
    """The activation hook is the identity on one rank and refuses a mesh
    of more (the port runs the model on one card)."""
    from repro_torch.launch.mesh import ShapeMesh
    one = ShapeMesh(("data", "model"), (1, 1))
    t = torch.ones(2, 3)
    for kind in ("hidden", "logits"):
        assert S.activation_constraint(one)(t, kind) is t
    for mesh in (FakeMesh2D(), FakeMesh3D()):
        with pytest.raises(ValueError, match="one card"):
            S.activation_constraint(mesh)


# ---------------------------------------------------------------------------
# the operation count
# ---------------------------------------------------------------------------


def test_count_matmul_exact():
    a, b = torch.zeros(64, 32), torch.zeros(32, 16)
    c = HC.count(lambda: a @ b)
    assert c.dot_flops == 2 * 64 * 32 * 16
    assert c.elem_flops == 0
    assert c.bytes == (64 * 32 + 32 * 16 + 64 * 16) * 4


def test_count_is_linear_in_a_loop_and_in_depth():
    A = torch.zeros(32, 32, device="meta")

    def loop(n):
        x = A
        for _ in range(n):
            x = torch.tanh(x @ A)
        return x
    one, seven = HC.count(loop, 1), HC.count(loop, 7)
    assert seven.dot_flops == 7 * one.dot_flops == 7 * 2 * 32 ** 3
    assert seven.elem_flops == 7 * 32 * 32
    assert seven.bytes == 7 * one.bytes
    cfg = get_config("granite-3-2b").reduced(n_layers=2)
    batch = {"tokens": torch.zeros(2, 16, dtype=torch.int32, device="meta")}
    per_depth = []
    for L in (2, 3, 4):
        c = dataclasses.replace(cfg, n_layers=L)
        per_depth.append(HC.count(M.forward, c, I.params_shapes(c),
                                  batch).dot_flops)
    assert per_depth[2] - per_depth[1] == per_depth[1] - per_depth[0] > 0


B_RED, S_RED = 2, 64


def _jax_batch(cfg, train_mode=False):
    sds = jax.ShapeDtypeStruct
    if cfg.family == "encoder":
        return {"frames": sds((B_RED, S_RED, cfg.frame_embed_dim),
                              jnp.float32)}
    b = {"tokens": sds((B_RED, S_RED), jnp.int32)}
    if cfg.family == "vlm":
        b["img"] = sds((B_RED, cfg.n_img_tokens, cfg.img_embed_dim),
                       jnp.float32)
    if train_mode:
        b["labels"] = sds((B_RED, S_RED), jnp.int32)
    return b


def _meta_batch(jb):
    dt = {"int32": torch.int32, "float32": torch.float32}
    return {k: torch.zeros(v.shape, dtype=dt[str(v.dtype)], device="meta")
            for k, v in jb.items()}


def _reduced(arch):
    n = 5 if arch == "zamba2-7b" else None
    kw = {} if n is None else {"n_layers": n}
    return jax_config(arch).reduced(**kw), get_config(arch).reduced(**kw)


@pytest.mark.parametrize("arch", ["granite-3-2b", "hubert-xlarge",
                                  "rwkv6-3b", "zamba2-7b", "pixtral-12b",
                                  "granite-moe-3b-a800m"])
def test_forward_dot_flops_equal_hlo_cost(arch):
    """The port's counted dot FLOPs of a reduced forward (B 2, S 64) are
    HloCost's of the reference's compiled forward.  granite-moe's
    reference dispatches and combines tokens by one-hot products (two
    einsums building the (E, cap) slot maps, one gathering tokens into the
    slots, one scattering them back), where the port indexes: the gap is
    exactly their FLOPs."""
    jc, tc = _reduced(arch)
    jb = _jax_batch(jc)
    text = jax.jit(lambda p, b: JM.forward(jc, p, b)[0]).lower(
        JI.params_shapes(jc), jb).compile().as_text()
    want = HloCost(text).total().dot_flops
    got = HC.count(M.forward, tc, I.params_shapes(tc),
                   _meta_batch(jb)).dot_flops
    gap = 0
    if tc.n_experts:
        T = B_RED * S_RED
        g = min(1024, T)
        n, E, K, d = T // g, tc.n_experts, tc.top_k, tc.d_model
        cap = max(K, int(math.ceil(g * K / E * tc.capacity_factor)))
        slot_maps = 2 * (2 * n * g * E * cap * K)
        gather_scatter = 2 * (2 * n * E * cap * d * g)
        gap = tc.n_layers * (slot_maps + gather_scatter)
        assert gap > 0
    assert want - got == gap


def test_gradient_dot_flops_equal_hlo_cost():
    jc, tc = _reduced("granite-3-2b")
    jb = _jax_batch(jc, train_mode=True)
    text = jax.jit(jax.grad(lambda p, b: JM.loss_fn(jc, p, b)[0])).lower(
        JI.params_shapes(jc), jb).compile().as_text()
    want = HloCost(text).total().dot_flops
    got = HC.count(train.loss_and_grads, tc, I.params_shapes(tc),
                   _meta_batch(jb)).dot_flops
    assert got == want


def test_roofline_terms():
    c = HC.Cost(dot_flops=989e12, elem_flops=0.0, bytes=3.35e12)
    c.coll["all-gather"] = 450e9
    rl = R.from_count(c, 1, model_flops=989e12 / 2)
    assert (rl.t_compute, rl.t_memory, rl.t_collective) == (1.0, 1.0, 1.0)
    assert rl.useful_flop_ratio == 0.5
    assert rl.row()["coll_by_kind"]["all-gather"] == int(450e9)


@pytest.mark.parametrize("Sq, Sk, causal, window, prefix", [
    (64, 64, True, 0, 0), (40, 64, True, 0, 0), (64, 64, False, 16, 0),
    (64, 64, True, 16, 0), (64, 64, True, 0, 20), (70, 50, True, 8, 30)])
def test_visible_pairs_is_the_masks_count(Sq, Sk, causal, window, prefix):
    kw = dict(causal=causal, window=window, prefix=prefix)
    assert ref.visible_pairs(Sq, Sk, **kw) == int(
        ref.attention_mask(Sq, Sk, **kw).sum())


def test_masked_flops_are_the_plain_attentions_masked_share():
    """One causal attention call with its backward: recorded as
    ``attention`` and ``attention_bwd``; its masked work is the plain
    version's counted forward and backward work times the masked share
    1 − (S + 1) / 2S; a bidirectional call masks nothing."""
    S = 64
    q, k, v = (torch.zeros(2, 4, S, 16, device="meta", requires_grad=True)
               for _ in range(3))
    with ops.record_calls() as calls:
        ops.attention(q, k, v, causal=True).sum().backward()
    assert [c.name for c in calls] == ["attention", "attention_bwd"]
    fwd = HC.count(ref.attention_ref, q, k, v, causal=True).flops
    o = ref.attention_ref(q, k, v, causal=True)
    bwd = HC.count(torch.autograd.grad, o, (q, k, v),
                   torch.zeros_like(o)).flops
    share = 1 - (S + 1) / (2 * S)
    assert DR.masked_flops(calls) == pytest.approx(share * (fwd + bwd))
    with ops.record_calls() as calls:
        ops.attention(q, k, v, causal=False)
    assert DR.masked_flops(calls) == 0


def test_recorded_calls_replay_in_their_layouts():
    """A reduced train step records each layer's attention twice (the
    checkpointed forward and its recompute) and its backward once; a
    decode records cached attention with its positions.  The replayed
    inputs have each call's shapes, strides and dtypes, and its
    positions."""
    cfg = get_config("granite-3-2b").reduced(n_layers=2)
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    g = torch.Generator().manual_seed(1)
    calls = []
    for name, seq in (("train_4k", 32), ("decode_32k", 48)):
        shape = dataclasses.replace(INPUT_SHAPES[name], seq_len=seq,
                                    global_batch=2)
        fn = DR.make_step(cfg, shape, params, "cpu", g)
        with ops.record_calls() as got:
            fn()
        calls += got
    names = [c.name for c in calls]
    assert names.count("attention") == 4 and all(
        c.grad for c in calls if c.name == "attention")
    assert names.count("attention_bwd") == 2
    assert names.count("attention_cached") == 2
    for call in calls:
        args = checks.replay_inputs(call, g, "cpu")
        for a, spec in zip(args, call.tensors):
            assert ops.TensorSpec.of(a) == spec
        if call.positions is not None:
            for a, p in zip(args[3:], call.positions):
                assert torch.equal(a, p)
    cached = [c for c in calls if c.name == "attention_cached"][0]
    assert cached.tensors[0].stride != tuple(
        torch.empty(cached.tensors[0].shape).stride())   # a view's layout


# ---------------------------------------------------------------------------
# the dry-run CLIs, in-process at a small size
# ---------------------------------------------------------------------------


def test_dryrun_count_only(tmp_path, monkeypatch):
    """``--count-only`` runs without the card: a row per pair with the
    roofline fields, hubert's decode a skip; the cut's rows and depth."""
    small = {a: dataclasses.replace(
        get_config(a).reduced(**({"n_layers": 6} if a == "zamba2-7b"
                                 else {})), name=a)
        for a in ("granite-3-2b", "hubert-xlarge", "zamba2-7b")}
    monkeypatch.setattr(DR, "get_config", lambda a: small[a])
    monkeypatch.setitem(DR.INPUT_SHAPES, "train_4k", dataclasses.replace(
        INPUT_SHAPES["train_4k"], seq_len=64))
    monkeypatch.setitem(DR.INPUT_SHAPES, "decode_32k", dataclasses.replace(
        INPUT_SHAPES["decode_32k"], seq_len=128))
    rows = []
    for arch in small:
        for shape in ("train_4k", "decode_32k"):
            rows.append(DR.run_pair(arch, shape, count_only=True,
                                    verbose=False))
    by = {(r["arch"], r["shape"]): r for r in rows}
    assert by["hubert-xlarge", "decode_32k"]["status"] == "skip"
    for (arch, shape), r in by.items():
        if r["status"] == "skip":
            continue
        assert r["status"] == "ok" and r["n_chips"] == 1
        assert r["rows"] == {"train_4k": 16, "decode_32k": 8}[shape]
        assert r["depth"] == 2            # the reduced hybrid: attn_every 2
        assert r["flops"] > 0 and r["hbm_bytes"] > 0
        assert r["useful_ratio"] > 0 and r["bottleneck"] in (
            "compute", "memory", "collective")
        assert "step_ms" not in r
    out = tmp_path / "rows.json"
    with contextlib.redirect_stdout(io.StringIO()) as log:
        rc = DR.main(["--arch", "granite-3-2b", "--shape", "decode_32k",
                      "--count-only", "--json-out", str(out)])
    assert rc == 0 and "ok=1 skip=0 fail=0" in log.getvalue()
    assert json.loads(out.read_text())[0]["status"] == "ok"


def test_dryrun_without_a_card_raises_unless_counting():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        DR.run_pair("granite-3-2b", "decode_32k", verbose=False)


def test_fedpft_dryrun_small(tmp_path):
    """The wire channel moves exactly Eqs. 9-11 (ratio 1.000), the raw
    channel its formula; fewer bytes than raw features."""
    out = tmp_path / "fd.json"
    with contextlib.redirect_stdout(io.StringIO()) as log:
        rc = FD.main(["--clients", "4", "--samples", "64", "--dim", "8",
                      "--classes", "3", "--k", "2", "--reps", "1",
                      "--device", "cpu", "--json", str(out)])
    text = log.getvalue()
    assert rc == 0
    ratios = [float(ln.rsplit("ratio=", 1)[1]) for ln in text.splitlines()
              if "ratio=" in ln]
    assert ratios == [1.0, 1.0]
    assert "fewer bytes" in text
    rows = json.loads(out.read_text())
    assert rows[0]["all_gather_bytes"] == rows[0]["predicted"]
    assert rows[0]["by_tag"]["wire"] == rows[0]["all_gather_bytes"]
