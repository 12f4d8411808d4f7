"""``chip_smoke.py``'s depth phase and ``serve.make_encode_step`` on the CPU.

The depth phase holds the main path's stack layer by layer: the model's
own blocks stepped one layer at a time (``chip_smoke.layer_steps``) must
give ``models.model.features`` bit for bit, and its f32 pass (each
layer's weights cast as it is reached) ``features`` on f32 weights, bit
for bit.  The phase itself runs here on 2-3 layers of each of the four
main-path families, with counting stand-ins for the kernel wrappers (the
plain versions, each call counted as a launch): its passes, launch
counts, carried errors and encode step, and a control in which a kernel
that disagrees with its plain version fails it.

``make_encode_step`` is held against ``repro.serve.make_encode_step`` on
the reference's weights carried into the port (``models.convert``), a
2-layer encoder, at the tolerances of the port's encoder parity test
(``tests/test_torch_model.py``): 1e-4 in f32, 3e-2 in bf16.
"""
import dataclasses
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import FOUNDATION_STANDIN as J_STANDIN
from repro.models import model as JM
from repro.serve import make_encode_step as j_make_encode_step
from repro_torch import serve as S
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.kernels import rms_norm as RMS
from repro_torch.kernels import ssd as SSD
from repro_torch.kernels import wkv6 as WKV
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_numpy

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

# each main-path backbone cut to 2-3 layers (zamba2-7b: three Mamba2
# layers and one use of the shared block, attn_every 2)
SMALL = {"hubert-xlarge": 2, "rwkv6-3b": 2, "zamba2-7b": 3,
         "granite-moe-3b-a800m": 2}


def _model(name):
    cfg = get_config(name).reduced(n_layers=SMALL[name], d_model=128)
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    return cfg, params


def _rows(cfg, n, seed=0):
    rng = np.random.RandomState(seed)
    if cfg.family == "encoder":
        return {"frames": rng.randn(n, 16, cfg.frame_embed_dim)
                .astype(np.float32)}
    return {"tokens": rng.randint(1, cfg.vocab_size, size=(n, 24))}


def _pooled(torch_, cfg, params, rows, f32=False):
    with torch.no_grad():
        steps = list(chip_smoke.layer_steps(torch_, cfg, params, rows,
                                            f32=f32))
    assert [b for b, _ in steps[:-1]] == chip_smoke.block_plan(cfg)
    assert steps[-1][0] == ("pooled", None)
    return steps[-1][1]


@pytest.mark.parametrize("name", sorted(SMALL))
def test_layer_steps_are_features_bit_for_bit(name):
    cfg, params = _model(name)
    rows = _rows(cfg, 2)
    got = _pooled(torch, cfg, params, rows)
    want = M.features(cfg, params, rows, device="cpu")
    assert got.dtype == torch.float32 and torch.equal(got, want)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_f32_pass_is_features_on_f32_weights(name):
    cfg, params = _model(name)
    rows = _rows(cfg, 2)
    got = _pooled(torch, cfg, params, rows, f32=True)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    want = M.features(cfg32, chip_smoke.cast_tree(params, torch.float32),
                      rows, device="cpu")
    assert torch.equal(got, want)
    # and it is another computation than the bf16 stack's
    assert not torch.equal(got, _pooled(torch, cfg, params, rows))


@pytest.mark.parametrize("name,blocks,uses", [
    ("hubert-xlarge", 48, 0), ("rwkv6-3b", 32, 0), ("zamba2-7b", 94, 13),
    ("granite-moe-3b-a800m", 32, 0)])
def test_block_plan_is_the_full_stack(name, blocks, uses):
    """At full depth: 48, 32 and 32 layers; zamba2-7b's 81 Mamba2
    layers with the shared block after every sixth (13 uses)."""
    cfg = get_config(name)
    plan = chip_smoke.block_plan(cfg)
    assert len(plan) == blocks
    assert sum(k == "shared" for k, _ in plan) == uses
    assert [i for k, i in plan if k != "shared"] == list(range(cfg.n_layers))


def _counting(monkeypatch, scale=None):
    """The wrappers as their plain versions, each call counted as its
    kernel's launch; ``scale`` multiplies attention's output (a kernel
    that disagrees)."""
    tables = {"attention": FA.LAUNCHES, "wkv6": WKV.LAUNCHES,
              "ssd": SSD.LAUNCHES, "rms_norm": RMS.LAUNCHES}
    for n, kname in chip_smoke.DEPTH_OPS.items():
        plain = getattr(ops, n)

        def call(*a, _plain=plain, _n=n, _k=kname, **kw):
            tables[_n][_k] += 1
            out = _plain(*a, **kw)
            return out * scale if scale and _n == "attention" else out
        monkeypatch.setattr(ops, n, call)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)


def _lines(capsys):
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]


@pytest.mark.parametrize("name", sorted(SMALL))
def test_depth_phase_on_the_cpu(name, monkeypatch, capsys):
    cfg, params = _model(name)
    _counting(monkeypatch)
    swapped = {n: getattr(ops, n) for n in chip_smoke.DEPTH_OPS}
    counts = chip_smoke.depth_phase(torch, torch.device("cpu"), "cpu", cfg,
                                    params, name, _rows(cfg, 2),
                                    _rows(cfg, 3, seed=1))
    assert {n: getattr(ops, n) for n in chip_smoke.DEPTH_OPS} == swapped
    lines = _lines(capsys)
    plan = chip_smoke.block_plan(cfg)
    layer = [ln for ln in lines if ln.get("phase") == "depth_layer"]
    assert [(ln["block"], ln["index"]) for ln in layer] == \
        [tuple(b) for b in plan] + [("pooled", None)]
    assert all(np.isfinite([ln["carried_kernel"], ln["carried_plain"]]).all()
               for ln in layer)
    (summary,) = [ln for ln in lines if ln.get("phase") == "depth"]
    expect = {k: f(cfg) for k, f in chip_smoke.PATHS[name].items()}
    assert summary["launches"] == summary["expected_launches"] == expect
    assert counts[f"depth/{name}"]["flash_attention"] == \
        expect.get("flash_attention", 0)
    assert summary["features_bitwise"] and summary["blocks"] == len(plan)
    # each kernel call of pass 1 held once per output, at its step
    checks = [ln for ln in lines if ln.get("phase") == "kernel_check"]
    outputs = {"flash_attention": 1, "wkv6": 2, "ssd": 2, "rms_norm": 1}
    assert len(checks) == sum(n * outputs[k] for k, n in expect.items())
    assert all(ln["mismatches"] == 0 and ln["case"] == f"depth {name}"
               for ln in checks)
    # every block's step, and the last norm's (the pooled step)
    assert {ln["step"] for ln in checks} == set(range(1, len(plan) + 2))
    # pass 1 runs the plain versions here (the counting stand-ins), as
    # pass 2 does: they carry the same error
    assert summary["carried"]["last"][0] == summary["carried"]["last"][1]
    assert summary["kernel_over_2x_plain"] is None
    encode = [ln for ln in lines if ln.get("phase") == "encode_step"]
    if cfg.family == "encoder":
        assert encode[0]["launches"] == {"flash_attention": cfg.n_layers,
                                         "rms_norm": 2 * cfg.n_layers + 1}
        assert encode[0]["pass1_logits_bitwise"]
        assert encode[0]["logits_shape"] == [3, 16, cfg.vocab_size]
        assert counts[f"encode_step/{name}"]["flash_attention"] == \
            cfg.n_layers
    else:
        assert not encode


def test_a_kernel_off_its_plain_version_fails_the_phase(monkeypatch,
                                                        capsys):
    """Control: attention's outputs 10 % off fail pass 1's first check,
    and the wrappers are put back."""
    cfg, params = _model("hubert-xlarge")
    _counting(monkeypatch, scale=1.1)
    swapped = {n: getattr(ops, n) for n in chip_smoke.DEPTH_OPS}
    with pytest.raises(AssertionError, match="outside tol"):
        chip_smoke.depth_phase(torch, torch.device("cpu"), "cpu", cfg,
                               params, "hubert-xlarge", _rows(cfg, 2),
                               _rows(cfg, 2))
    assert {n: getattr(ops, n) for n in chip_smoke.DEPTH_OPS} == swapped
    (check,) = [ln for ln in _lines(capsys)
                if ln.get("phase") == "kernel_check"
                and ln["kernel"] == "flash_attention"]
    assert check["step"] == 1 and check["mismatches"] > 0


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 3e-2)])
def test_make_encode_step_matches_the_reference(dtype, tol):
    jcfg = dataclasses.replace(J_STANDIN, n_layers=2, d_model=64, n_heads=2,
                               n_kv_heads=2, head_dim=32, d_ff=96,
                               frame_embed_dim=16, dtype=dtype)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(3))
    tparams = params_from_numpy(
        tcfg, jax.tree.map(lambda a: np.asarray(a, np.float32), jparams),
        device="cpu")
    frames = np.random.RandomState(0).randn(3, 8, 16).astype(np.float32)
    exp = np.asarray(j_make_encode_step(jcfg)(jparams, {"frames": frames}))
    got = S.make_encode_step(tcfg, device="cpu")(tparams,
                                                 {"frames": frames})
    assert got.dtype == torch.float32
    assert got.shape == exp.shape == (3, 8, tcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), exp, rtol=tol, atol=tol)


def test_make_encode_step_needs_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = get_config("hubert-xlarge").reduced(n_layers=1, d_model=64)
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        S.make_encode_step(cfg)(params, _rows(cfg, 1))
