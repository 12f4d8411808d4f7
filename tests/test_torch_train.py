"""Training in the port against the JAX package, on the CPU at tiny f32
sizes: ``models.model.loss_fn`` and its gradients for every family,
``train.make_train_step`` (sgd exactly, Adam within lr where a gradient
is near 0), microbatching, ``make_eval_step``, and the optimizers over
nested trees (the pure ``update`` against the reference's, the in-place
``update_`` against the pure one).

The reference's weights are carried into the port
(``models.convert.params_from_numpy``), inputs come from numpy seeds.
Tolerances, f32: losses 1e-5 relative; each gradient leaf within 2e-4 ×
that leaf's largest reference value (both frameworks sum in their own
order through up to two blocks, a chunked recurrence and the xent);
parameters after one sgd step 1e-6 absolute (lr · the gradient's error).
The configs keep ``remat`` on, so the port's blocks run under activation
checkpointing as the reference's run under ``jax.checkpoint``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as JO
from repro import train as JT
from repro.configs import get_config as j_get_config
from repro.models import model as JM
from repro_torch import optim, train
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_numpy

# one config per family, cut to 2 layers of d 64 (grok-1: 4 experts of
# which the router picks 2)
FAMILIES = {"dense": "granite-3-2b", "moe": "grok-1-314b",
            "vlm": "pixtral-12b", "encoder": "hubert-xlarge",
            "ssm": "rwkv6-3b", "hybrid": "zamba2-7b"}
B, S = 2, 16
GRAD_TOL = 2e-4


def _cfgs(name, **over):
    ref = dataclasses.replace(
        j_get_config(name).reduced(n_layers=2, d_model=64),
        dtype="float32", **over)
    return ref, ModelConfig(**dataclasses.asdict(ref))


def _carried(jcfg, tcfg, seed=3):
    jparams = jax.jit(JM.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(seed))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jparams)
    return jparams, params_from_numpy(tcfg, tree, device="cpu")


def _batch(cfg, seed=0, rows=B):
    rs = np.random.RandomState(seed)
    if cfg.family == "encoder":
        return {"frames": rs.randn(rows, S, cfg.frame_embed_dim)
                .astype(np.float32),
                "mask": rs.rand(rows, S) < 0.4,
                "targets": rs.randint(0, cfg.vocab_size, (rows, S))
                .astype(np.int32)}
    b = {"tokens": rs.randint(0, cfg.vocab_size, (rows, S)).astype(np.int32),
         "labels": rs.randint(0, cfg.vocab_size, (rows, S)).astype(np.int32)}
    if cfg.family == "vlm":
        b["img"] = rs.randn(rows, cfg.n_img_tokens,
                            cfg.img_embed_dim).astype(np.float32)
    return b


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _pairs(jtree, ttree, prefix=""):
    """(path, reference leaf as numpy, port leaf) over the port's tree."""
    for k, v in ttree.items():
        if isinstance(v, dict):
            yield from _pairs(jtree[k], v, f"{prefix}{k}/")
        elif v is not None:
            yield prefix + k, np.asarray(jtree[k], np.float32), v


def _close_by_leaf(jtree, ttree, tol):
    for path, e, g in _pairs(jtree, ttree):
        g = g.detach().float().numpy()
        assert g.shape == e.shape, path
        scale = max(float(np.abs(e).max()), 1e-30)
        err = float(np.abs(g - e).max())
        assert err <= tol * scale, (path, err, scale)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_loss_and_every_gradient_leaf_match_the_reference(family):
    jcfg, tcfg = _cfgs(FAMILIES[family])
    jp, tp = _carried(jcfg, tcfg)
    batch = _batch(tcfg)
    (jloss, jm), jg = jax.jit(jax.value_and_grad(
        JM.loss_fn, argnums=1, has_aux=True), static_argnums=0)(
        jcfg, jp, _j(batch))
    live = optim.tree_map(lambda p: p.detach().requires_grad_(), tp)
    loss, m = M.loss_fn(tcfg, live, _t(batch))
    grads = torch.autograd.grad(loss, optim.tree_leaves(live))
    loss = loss.detach()
    it = iter(grads)
    tg = optim.tree_map(lambda p: next(it), tp)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(m["xent"]), float(jm["xent"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["aux"]), float(jm["aux"]), rtol=1e-5,
                               atol=1e-8)
    assert (float(m["aux"]) > 0) == (family == "moe")
    _close_by_leaf(jg, tg, GRAD_TOL)


def _clone(tree):
    return optim.tree_map(lambda t: t.clone(), tree)


@pytest.fixture(scope="module")
def dense():
    """granite-3-2b cut to 2 layers of d 64, f32: (configs, params, batch
    of 4 rows)."""
    jcfg, tcfg = _cfgs("granite-3-2b")
    jp, tp = _carried(jcfg, tcfg, seed=4)
    return jcfg, tcfg, jp, tp, _batch(tcfg, seed=1, rows=4)


def test_sgd_train_step_matches_the_reference(dense):
    jcfg, tcfg, jp, tp, batch = dense
    lr = 0.5
    jstep = jax.jit(JT.make_train_step(jcfg, JO.sgd(lr)))
    jopt = JO.sgd(lr)
    jp1, _, jmet = jstep(jp, jopt.init(jp), _j(batch))
    opt = optim.sgd(lr)
    params = _clone(tp)
    p1, st, met = train.make_train_step(tcfg, opt)(params, opt.init(params),
                                                    _t(batch))
    assert p1 is params and st["count"] == 1        # updated in place
    for k in ("loss", "xent", "aux", "grad_norm"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-5,
                                   atol=1e-8, err_msg=k)
    for path, e, g in _pairs(jp1, p1):
        np.testing.assert_allclose(g.numpy(), e, rtol=0, atol=1e-6,
                                   err_msg=path)


def test_adam_train_step_matches_within_lr_where_gradients_vanish(dense):
    """Adam's first step is about −lr·sign(g): where |g| is below 1e-3 of
    its leaf's max the sign may differ between the frameworks, so those
    entries are held within 2·lr, the others within 1e-3·lr."""
    jcfg, tcfg, jp, tp, batch = dense
    lr = 1e-2
    jopt = JO.adam(lr)
    jp1, _, _ = jax.jit(JT.make_train_step(jcfg, jopt))(jp, jopt.init(jp),
                                                        _j(batch))
    (_, _), jg = jax.jit(jax.value_and_grad(
        JM.loss_fn, argnums=1, has_aux=True), static_argnums=0)(
        jcfg, jp, _j(batch))
    opt = optim.adam(lr)
    params = _clone(tp)
    p1, _, _ = train.make_train_step(tcfg, opt)(params, opt.init(params),
                                                _t(batch))
    for (path, e, got), (_, g, _) in zip(_pairs(jp1, p1), _pairs(jg, tp)):
        small = np.abs(g) < 1e-3 * np.abs(g).max()
        err = np.abs(got.numpy() - e)
        assert (err[~small] <= 1e-3 * lr).all(), path
        assert (err[small] <= 2 * lr).all(), path


def test_microbatch_step_matches_the_full_batch_and_the_reference(dense):
    """Two microbatches of 2 rows: the mean of their mean losses is the
    full batch's mean (every row has S labels), so the sgd step equals
    the full-batch step; and it equals the reference's microbatch step."""
    jcfg, tcfg, jp, tp, batch = dense
    opt = optim.sgd(0.5)
    full = _clone(tp)
    p_full, _, m_full = train.make_train_step(tcfg, opt)(
        full, opt.init(full), _t(batch))
    micro = _clone(tp)
    p_mb, _, m_mb = train.make_train_step(tcfg, opt, microbatch=2)(
        micro, opt.init(micro), _t(batch))
    np.testing.assert_allclose(float(m_mb["loss"]), float(m_full["loss"]),
                               rtol=1e-6)
    assert float(m_mb["aux"]) == 0.0
    jopt = JO.sgd(0.5)
    jp1, _, jmet = jax.jit(JT.make_train_step(jcfg, jopt, microbatch=2))(
        jp, jopt.init(jp), _j(batch))
    np.testing.assert_allclose(float(m_mb["loss"]), float(jmet["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m_mb["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-5)
    for (path, e, g), (_, _, f) in zip(_pairs(jp1, p_mb),
                                       _pairs(jp1, p_full)):
        np.testing.assert_allclose(g.numpy(), e, rtol=0, atol=1e-6,
                                   err_msg=path)
        np.testing.assert_allclose(g.numpy(), f.numpy(), rtol=0, atol=1e-6,
                                   err_msg=path)


def test_eval_step_matches_the_reference(dense):
    jcfg, tcfg, jp, tp, batch = dense
    jmet = JT.make_eval_step(jcfg)(jp, _j(batch))
    met = train.make_eval_step(tcfg)(tp, _t(batch))
    assert not met["loss"].requires_grad
    for k in ("loss", "xent", "aux"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-5,
                                   atol=1e-8, err_msg=k)


SHAPES = {"a": (3, 4), "blocks": {"w": (2, 5, 3), "ln": (2, 5)},
          "deep": {"x": {"y": (7,)}}}


def _tree(seed):
    """A nested tree of f32 numpy leaves of ``SHAPES``."""
    rs = np.random.RandomState(seed)
    return optim.tree_map(lambda sh: rs.randn(*sh).astype(np.float32),
                          SHAPES)


@pytest.mark.parametrize("make", [
    lambda m: m.sgd(0.1, momentum=0.9, nesterov=True),
    lambda m: m.adam(m.cosine_schedule(1e-2, 10, warmup_steps=2),
                     weight_decay=0.1),
    lambda m: m.yogi(1e-2)], ids=["sgd", "adam", "yogi"])
def test_optimizers_over_nested_trees(make):
    """Three steps over a nested tree: the pure update against the
    reference's (1e-6), and the in-place ``update_`` bitwise the pure
    update followed by ``apply_updates``."""
    p_np = _tree(0)
    jopt, opt = make(JO), make(optim)
    jp = jax.tree.map(jnp.asarray, p_np)
    jst = jopt.init(jp)
    tp = optim.tree_map(torch.from_numpy, p_np)
    st = opt.init(tp)
    ip = _clone(tp)
    ist = opt.init(ip)
    for step in range(3):
        g_np = _tree(step + 1)
        ju, jst = jopt.update(jax.tree.map(jnp.asarray, g_np), jst, jp)
        jp = JO.apply_updates(jp, ju)
        g = optim.tree_map(torch.from_numpy, g_np)
        u, st = opt.update(g, st, tp)
        tp = optim.apply_updates(tp, u)
        ist = opt.update_(g, ist, ip)
        for path, e, got in _pairs(jp, tp):
            np.testing.assert_allclose(got.numpy(), e, rtol=0, atol=1e-6,
                                       err_msg=path)
        for a, b in zip(optim.tree_leaves(ip), optim.tree_leaves(tp)):
            assert torch.equal(a, b)
        for name in ("m", "v", "mu"):
            if st.get(name) is not None:
                for a, b in zip(optim.tree_leaves(ist[name]),
                                optim.tree_leaves(st[name])):
                    assert torch.equal(a, b)
    assert ist["count"] == st["count"] == 3
