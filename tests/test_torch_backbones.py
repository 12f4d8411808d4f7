"""The port's rwkv6-3b (ssm) and zamba2-7b (hybrid) backbones against the
JAX package, and the slice's pipeline from their features.

The reference's ``init_params`` weights are carried into the port
(``models.convert.params_from_numpy``); both must then compute the same
features from the same token ids: 1e-4 in f32, and 3e-2 in bf16, where
the two frameworks round the activations to bf16 at different places (as
``tests/test_torch_model.py``).  ``reduced()`` sets chunk 32, so T = 64 is
two chunks with a state carried between them and T = 40 takes the
``C = T`` rule; zamba2's 5 layers with ``attn_every = 2`` are two uses of
the shared block and a 1-layer tail.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import model as JM
from repro_torch import data as D
from repro_torch.configs import get_config
from repro_torch.core import fedpft as FP
from repro_torch.core import gmm as G
from repro_torch.core import head as H
from repro_torch.models import mamba2, rwkv
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_numpy

F32_LEAVES = {"ssm": ("w0", "u"), "hybrid": ("A_log", "dt_bias", "D")}
REDUCED = {"rwkv6-3b": {}, "zamba2-7b": {"n_layers": 5}}


def _cfgs(name, **over):
    ref = dataclasses.replace(j_get_config(name).reduced(**REDUCED[name]),
                              **over)
    return ref, ModelConfig(**dataclasses.asdict(ref))


def _carried(jcfg, tcfg, seed=3):
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jparams)
    return jparams, params_from_numpy(tcfg, tree, device="cpu")


def _tokens(x, n_bins):
    """Class-Gaussian values to token ids 1 … n_bins by uniform binning of
    [−6, 6], clipped at the ends."""
    ids = np.floor((x + 6.0) / 12.0 * n_bins).astype(np.int64)
    return 1 + np.clip(ids, 0, n_bins - 1)


@pytest.mark.parametrize("name", sorted(REDUCED))
@pytest.mark.parametrize("dtype,T,tol", [
    ("float32", 64, 1e-4), ("float32", 40, 1e-4), ("bfloat16", 64, 3e-2)])
def test_features_with_carried_weights(name, dtype, T, tol):
    jcfg, tcfg = _cfgs(name, dtype=dtype)
    jparams, tparams = _carried(jcfg, tcfg)
    tokens = np.random.RandomState(T).randint(1, tcfg.vocab_size, (3, T))
    exp = np.asarray(JM.features(jcfg, jparams, {"tokens": tokens}))
    got = M.features(tcfg, tparams, {"tokens": tokens}, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (3, tcfg.d_model)
    np.testing.assert_allclose(got.numpy(), exp, rtol=tol, atol=tol)


@pytest.mark.parametrize("name", sorted(REDUCED))
def test_reference_f32_leaves_stay_f32(name):
    """Under a bf16 config the leaves the reference keeps in f32 stay f32,
    carried or drawn; every other leaf is bf16."""
    jcfg, tcfg = _cfgs(name)
    _, carried = _carried(jcfg, tcfg)
    g = torch.Generator()
    g.manual_seed(0)
    drawn = M.init_params(tcfg, g, device="cpu")
    keep = F32_LEAVES[tcfg.family]
    for params in (carried, drawn):
        for k, v in params["blocks"].items():
            want = torch.float32 if k in keep else torch.bfloat16
            assert v.dtype == want, (k, v.dtype)
        assert params["embed"].dtype == torch.bfloat16


def test_init_params_shapes_match_reference():
    for name in REDUCED:
        jcfg, tcfg = _cfgs(name)
        g = torch.Generator()
        g.manual_seed(0)
        p = M.init_params(tcfg, g, device="cpu")
        shapes = jax.eval_shape(lambda: JM.init_params(
            jcfg, jax.random.PRNGKey(0)))
        flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
        assert len(flat) == sum(len(v) if isinstance(v, dict) else 1
                                for v in p.values())
        for path, leaf in flat:
            node = p
            for key in path:
                node = node[key.key]
            assert tuple(node.shape) == leaf.shape, (name, path)


def test_configs_match_reference():
    for name in REDUCED:
        assert dataclasses.asdict(get_config(name)) == \
            dataclasses.asdict(j_get_config(name))


@pytest.mark.parametrize("name", sorted(REDUCED))
def test_decode_block_runs_and_moe_vlm_relu2_overrides_forward(name):
    """A one-token step with ``use_cache=True`` is the decode step and
    runs; the config turned moe (4 experts, top 2), vlm (an image prefix
    of 4) or relu2 draws its weights and runs ``forward`` to finite
    logits (the moe with a positive aux loss)."""
    _, tcfg = _cfgs(name)
    g = torch.Generator()
    g.manual_seed(0)
    p = M.init_params(tcfg, g, device="cpu")
    x = torch.zeros(1, 1, tcfg.d_model, dtype=torch.bfloat16)
    layer = {k: v[0] for k, v in p["blocks"].items()}
    if tcfg.family == "ssm":
        state = rwkv.init_rwkv_state(tcfg, 1, "cpu", n_layers=1)
        block = rwkv.rwkv_block
    else:
        state = mamba2.init_mamba_state(tcfg, 1, 1, "cpu")
        block = mamba2.mamba_block
    state = {k: v[0] for k, v in state.items()}
    y, new = block(tcfg, x, layer, state, use_cache=True)
    assert y.shape == x.shape and bool(torch.isfinite(y.float()).all())
    assert {k: v.shape for k, v in new.items()} == \
        {k: v.shape for k, v in state.items()}
    tokens = torch.randint(0, tcfg.vocab_size, (2, 6), generator=g)
    for over in ({"family": "moe", "n_experts": 4, "top_k": 2},
                 {"family": "vlm", "n_img_tokens": 4, "img_embed_dim": 32},
                 {"family": "dense", "mlp_variant": "relu2"}):
        cfg = dataclasses.replace(tcfg, **over)
        params = M.init_params(cfg, g, device="cpu")
        batch = {"tokens": tokens}
        if cfg.family == "vlm":
            batch["img"] = torch.randn(2, 4, 32, generator=g)
        logits, aux, _ = M.forward(cfg, params, batch)
        assert logits.shape == (2, 6 + M.n_img(cfg), cfg.vocab_size)
        assert bool(torch.isfinite(logits).all()), over
        assert (float(aux) > 0) == (cfg.family == "moe"), over


def backbone_rounds(name, seeds):
    """Features of the backbone → 3 clients' class-wise GMMs → bf16 wire →
    fused head, one round per seed: (FedPFT test accuracy per seed,
    centralized accuracy, the last round's info).  Tokens bin the values
    coarsely (16 ids), so that a random embedding keeps the class signal.
    ``tests/sweep_backbone_bar.py`` runs it over many seeds."""
    _, tcfg = _cfgs(name, dtype="float32")
    g = torch.Generator()
    g.manual_seed(0)
    params = M.init_params(tcfg, g, device="cpu")
    dcfg = D.DatasetConfig(n_classes=4, n_per_class=40, input_dim=32,
                           class_sep=3.0)
    feats = {}
    for split in (0, 1):
        x, y = D.make_dataset(dcfg, split=split)
        f = M.features(tcfg, params, {"tokens": _tokens(x, 16)},
                       device="cpu")
        feats[split] = (f, torch.from_numpy(y).long())
    (f, y), (ft, yt) = feats[0], feats[1]
    parts = D.iid_shards(len(y), 3)
    cfg = FP.FedPFTConfig(
        gmm=G.GMMConfig(n_components=2, cov_type="diag", n_iter=10),
        head=H.HeadConfig(n_steps=250, lr=3e-3))
    clients = [(f[p], y[p]) for p in parts]
    accs = []
    for seed in seeds:
        head, info = FP.run_fedpft(clients, 4, cfg, seed=seed, device="cpu")
        accs.append(float(H.accuracy(head, ft, yt)))
    head_c, _ = FP.centralized_baseline(clients, 4, cfg, device="cpu")
    return accs, float(H.accuracy(head_c, ft, yt)), info


@pytest.mark.parametrize("name", sorted(REDUCED))
def test_pipeline_from_backbone_features_meets_the_reference_bar(name):
    """FedPFT within 0.08 of the centralized head
    (``tests/test_system.py``) on the backbone's features.  At 160 test
    rows one round's accuracy spreads over 0.81–0.86 across seeds
    (zamba2-7b's cut, ``tests/sweep_backbone_bar.py``), across the bar,
    so the bar holds the mean of four rounds (seeds 0–3)."""
    accs, acc_c, info = backbone_rounds(name, range(4))
    acc = sum(accs) / len(accs)
    assert acc > acc_c - 0.08, (accs, acc_c)
    assert acc_c > 0.5, acc_c            # the features carry the classes
    assert info["comm_bytes"] == sum(len(m.payload)
                                     for m in info["messages"])
