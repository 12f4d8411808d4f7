"""The port's encoder backbone and data against the JAX package.

The reference's ``init_params`` weights are carried into the port
(``models.convert.params_from_numpy``); both must then compute the same
features: 1e-4 in f32, and 3e-2 in bf16, where the two frameworks round
the activations to bf16 at different places.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import data as JD
from repro.configs import FOUNDATION_STANDIN as J_STANDIN
from repro.configs import get_config as j_get_config
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch import data as D
from repro_torch.configs import FOUNDATION_STANDIN, get_config
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_numpy


def _cfgs(**over):
    ref = dataclasses.replace(J_STANDIN, **over)
    return ref, ModelConfig(**dataclasses.asdict(ref))


def _numpy_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _frames(seed, B, S, F):
    return np.random.RandomState(seed).randn(B, S, F).astype(np.float32)


class TestFeaturesParity:
    @pytest.mark.parametrize("dtype,heads,kv,hd,tol", [
        ("float32", 2, 2, 32, 1e-4),
        ("float32", 4, 2, 16, 1e-4),       # GQA
        ("float32", 2, 2, 80, 1e-4),       # hubert-xlarge's head_dim
        ("bfloat16", 2, 2, 32, 3e-2),
    ])
    def test_features_with_carried_weights(self, dtype, heads, kv, hd, tol):
        jcfg, tcfg = _cfgs(n_layers=2, d_model=heads * hd, n_heads=heads,
                           n_kv_heads=kv, head_dim=hd, d_ff=96,
                           frame_embed_dim=16, dtype=dtype)
        jparams = JM.init_params(jcfg, jax.random.PRNGKey(3))
        tparams = params_from_numpy(tcfg, _numpy_tree(jparams),
                                    device="cpu")
        frames = _frames(0, 3, 8, 16)
        exp = np.asarray(JM.features(jcfg, jparams, {"frames": frames}))
        got = M.features(tcfg, tparams, {"frames": frames}, device="cpu")
        assert got.dtype == torch.float32 and got.shape == (3, heads * hd)
        np.testing.assert_allclose(got.numpy(), exp, rtol=tol, atol=tol)

    def test_layers_match_reference(self):
        rng = np.random.RandomState(1)
        x = rng.randn(2, 6, 4, 8).astype(np.float32)
        pos = np.arange(6)
        np.testing.assert_allclose(
            L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                         1e6).numpy(),
            np.asarray(JL.apply_rope(x, pos, 1e6)), rtol=1e-5, atol=1e-5)
        g = rng.rand(8).astype(np.float32)
        np.testing.assert_allclose(
            L.rms_norm(torch.from_numpy(x), torch.from_numpy(g)).numpy(),
            np.asarray(JL.rms_norm(x, g)), rtol=1e-5, atol=1e-5)
        jcfg, tcfg = _cfgs(d_model=8, d_ff=16, dtype="float32")
        w = {"w_in": rng.randn(8, 16).astype(np.float32),
             "w_out": rng.randn(16, 8).astype(np.float32)}
        np.testing.assert_allclose(
            L.mlp(torch.from_numpy(x), {k: torch.from_numpy(v)
                                        for k, v in w.items()}, tcfg).numpy(),
            np.asarray(JL.mlp(x, w, jcfg)), rtol=1e-4, atol=1e-4)

    def test_init_params_law(self):
        cfg = FOUNDATION_STANDIN.reduced(n_layers=2, d_model=64)
        g = torch.Generator()
        g.manual_seed(0)
        p = M.init_params(cfg, g, device="cpu")
        jshapes = jax.eval_shape(lambda: JM.init_params(
            j_get_config("foundation-standin").reduced(n_layers=2,
                                                       d_model=64),
            jax.random.PRNGKey(0)))
        assert p["blocks"]["wq"].shape == jshapes["blocks"]["wq"].shape
        assert p["frame_proj"].shape == jshapes["frame_proj"].shape
        assert p["blocks"]["w_out"].dtype == torch.bfloat16
        std = float(p["blocks"]["w_in"].float().std())
        assert abs(std * np.sqrt(64) - 1.0) < 0.05
        assert torch.all(p["blocks"]["ln1"] == 1)

    def test_configs_match_reference(self):
        assert dataclasses.asdict(get_config("hubert-xlarge")) == \
            dataclasses.asdict(j_get_config("hubert-xlarge"))
        assert dataclasses.asdict(FOUNDATION_STANDIN) == \
            dataclasses.asdict(J_STANDIN)
        assert dataclasses.asdict(FOUNDATION_STANDIN.reduced()) == \
            dataclasses.asdict(J_STANDIN.reduced())
        kept = dataclasses.replace(get_config("hubert-xlarge"), d_model=64)
        assert kept.head_dim == 80        # head_dim is a stored field

    def test_entry_point_needs_cuda_unless_cpu_is_asked(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present")
        cfg = FOUNDATION_STANDIN.reduced(n_layers=1, d_model=64)
        with pytest.raises(RuntimeError, match="CUDA"):
            M.init_params(cfg, torch.Generator())

    def test_weight_conversion_needs_cuda_unless_cpu_is_asked(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present")
        jcfg, tcfg = _cfgs(n_layers=1, d_model=64, n_heads=2, n_kv_heads=2,
                           head_dim=32, d_ff=96, frame_embed_dim=16,
                           dtype="float32")
        tree = _numpy_tree(JM.init_params(jcfg, jax.random.PRNGKey(0)))
        with pytest.raises(RuntimeError, match="CUDA"):
            params_from_numpy(tcfg, tree)
        on_cpu = params_from_numpy(tcfg, tree, device="cpu")
        assert on_cpu["blocks"]["wq"].device.type == "cpu"


class TestDataIsBitIdentical:
    @pytest.mark.parametrize("domains,split", [(1, 0), (1, 1), (3, 0)])
    def test_make_dataset(self, domains, split):
        cfg_t = D.DatasetConfig(n_classes=5, n_per_class=20, input_dim=12,
                                n_domains=domains, seed=4)
        cfg_j = JD.DatasetConfig(**dataclasses.asdict(cfg_t))
        xt, yt = D.make_dataset(cfg_t, domain=domains - 1, split=split)
        xj, yj = JD.make_dataset(cfg_j, domain=domains - 1, split=split)
        np.testing.assert_array_equal(xt, np.asarray(xj))
        np.testing.assert_array_equal(yt, np.asarray(yj))
        assert xt.dtype == np.float32 and yt.dtype == np.int32

    def test_partitioners(self):
        labels = np.random.RandomState(0).randint(0, 6, 300)
        for a, b in zip(D.iid_shards(300, 4, seed=2),
                        JD.iid_shards(300, 4, seed=2)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(D.dirichlet_partition(labels, 5, 0.3, seed=1),
                        JD.dirichlet_partition(jnp.asarray(labels), 5, 0.3,
                                               seed=1)):
            np.testing.assert_array_equal(a, b)
