"""The one-pass RMS norm (``kernels/rms_norm.py``, ``csrc/rms_norm.cu``) and
its routes: ``ops.rms_norm``'s plain route and ``models.layers.rms_norm``
without a gradient are the plain expression bit for bit on the CPU; the
launch plan fits the card at every width the configurations use; the
wrapper refuses what the kernel does not take.

The ``cuda`` cases hold the kernel against the plain version on a card, at
the benchmark's shapes (hubert-xlarge's (16384, 1280), zamba2-7b's (32768,
3584) and its gated (32768, 7168) with ``z`` a split view of the
in-projection), at 16 decode rows, at an odd width and in f32: in bf16 at
most one bf16 step apart and equal on at least 99.9 % of the values (the
two differ only in the order of the sum of squares); the gated norm at
most two steps apart (one step of the bf16 norm before the product is two
of the product where its exponent is the higher), and to a step the
kernel's own norm times silu(z); in f32 within 1e-5 relative (the order of
the sum changes the last bit of a row's rsqrt, and so of most of its
values).  The file imports no JAX, so it runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_rms_norm.py
"""
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.analysis import pallas_rules
from repro_torch.configs import ARCHS, get_config
from repro_torch.kernels import checks, ops, ref
from repro_torch.kernels import rms_norm as RMS
from repro_torch.models import layers
from repro_torch.models import model as M
from repro_torch.models.mamba2 import mamba_dims

WIDTHS = [1280, 3584, 7168, 1283]
DTYPES = [torch.bfloat16, torch.float32]


def _plain(x, gamma, eps=1e-6):
    """``layers.rms_norm`` as the port wrote it before the kernel."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * gamma.float()).to(dt)


def _inputs(rows, d, dtype, device="cpu", seed=0, gate=False):
    g = torch.Generator(device=device).manual_seed(seed)
    return checks.rms_norm_inputs(g, device, rows, d, dtype, gate)


@pytest.mark.parametrize("gate", [False, True], ids=["norm", "gated"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("d", WIDTHS)
def test_plain_route_is_the_plain_expression_bit_for_bit(d, dtype, gate):
    x, gamma, z = _inputs(6, d, dtype, gate=gate)
    want = _plain(x, gamma)
    if gate:
        want = want * F.silu(z)
    for got in (ops.rms_norm(x, gamma, z), layers.rms_norm(x, gamma, z=z),
                ref.rms_norm_ref(x, gamma, z=z)):
        assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("gate", [False, True], ids=["norm", "gated"])
def test_with_a_gradient_the_plain_expression_and_its_gradient(gate):
    x, gamma, z = _inputs(5, 96, torch.float32, gate=gate)
    leaves = [t.clone().requires_grad_() for t in (x, gamma)]
    got = layers.rms_norm(*leaves, z=z)
    got.square().sum().backward()
    plain = [t.clone().requires_grad_() for t in (x, gamma)]
    want = _plain(*plain) * (1.0 if z is None else F.silu(z))
    want.square().sum().backward()
    assert torch.equal(got, want)
    for a, b in zip(leaves, plain):
        assert torch.equal(a.grad, b.grad)


def _widths():
    out = set()
    for name in ARCHS:
        cfg = get_config(name)
        out.add(cfg.d_model)
        if cfg.family == "hybrid":
            out.add(mamba_dims(cfg)[0])
    return sorted(out)


@pytest.mark.parametrize("d", _widths())
def test_launch_plan_fits_the_card_at_every_configured_width(d):
    for es in (2, 4):
        for aligned in (True, False):
            for rows in (1, 16, 16384, 32768):
                p = RMS.launch_plan(d, rows, es, aligned)
                assert p.tpr >= 32 and p.tpr & (p.tpr - 1) == 0
                assert p.threads == p.tpr * p.rpb <= RMS.MAX_THREADS
                assert p.smem_bytes <= pallas_rules.SMEM_LIMIT_BYTES
                assert p.blocks * p.rpb >= rows > (p.blocks - 1) * p.rpb
                assert d % p.vec == 0
                if not p.smem:
                    assert p.vec * RMS.CHUNKS * p.tpr >= d
    # the main paths' widths hold their rows in registers, 16 bytes a load
    if d in (1280, 3584, 7168):
        assert not RMS.launch_plan(d, 32768, 2).smem
        assert RMS.launch_plan(d, 32768, 2).vec == 8


@pytest.mark.parametrize("d,es,aligned,vec,tpr,smem", [
    (1280, 2, True, 8, 64, False),       # hubert-xlarge
    (3584, 2, True, 8, 128, False),      # zamba2-7b's d_model
    (7168, 2, True, 8, 256, False),      # zamba2-7b's d_inner (gated)
    (1283, 2, True, 1, 512, False),      # odd: one value a load
    (1280, 2, False, 1, 512, False),     # a misaligned view
    (18432, 2, True, 8, 1024, False),    # nemotron-4-340b
    (18432, 4, True, 4, 1024, True),     # …in f32: the row in shared memory
])
def test_launch_plan_by_shape(d, es, aligned, vec, tpr, smem):
    p = RMS.launch_plan(d, 16384, es, aligned)
    assert (p.vec, p.tpr, p.smem) == (vec, tpr, smem)
    # decode: few rows, one row a block
    assert RMS.launch_plan(d, 16, es, aligned).rpb == 1


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x, gamma, z = _inputs(4, 64, torch.bfloat16, gate=True)
    with pytest.raises(ValueError, match="must be one of"):
        RMS.rms_norm(x.half(), gamma.half())
    with pytest.raises(ValueError, match="gamma must be"):
        RMS.rms_norm(x, gamma[:-1])
    with pytest.raises(ValueError, match="gamma must be"):
        RMS.rms_norm(x, gamma.float())
    with pytest.raises(ValueError, match="z must be"):
        RMS.rms_norm(x, gamma, z=z[:, :-8])
    with pytest.raises(ValueError, match="z must be"):
        RMS.rms_norm(x, gamma, z=z.float())
    with pytest.raises(ValueError, match="CUDA"):
        RMS.rms_norm(x, gamma, z=z)


def test_bf16_steps_counts_the_steps_between_values():
    a = torch.tensor([1.0, -2.0, 0.0, 3.0]).bfloat16()
    up = torch.nextafter(a.float(), torch.full((4,), 1e9)).bfloat16()
    assert checks.bf16_steps(a, a).tolist() == [0, 0, 0, 0]
    # one f32 step up rounds back to a; one bf16 step up is 1
    assert checks.bf16_steps(a, up).tolist() == [0, 0, 0, 0]
    nxt = (a.view(torch.int16) + torch.tensor([1, -1, 1, 1],
                                              dtype=torch.int16)
           ).view(torch.bfloat16)
    assert checks.bf16_steps(a, nxt).tolist() == [1, 1, 1, 1]
    assert checks.bf16_steps(torch.tensor([0.0]).bfloat16(),
                             torch.tensor([-0.0]).bfloat16()).tolist() == [0]


def test_cpu_calls_count_no_kernel_and_no_plain_row():
    cfg = get_config("zamba2-7b").reduced(n_layers=2, d_model=64)
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    ops.reset_launch_counts()
    obs.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        M.features(cfg, params, {"tokens": torch.ones(2, 8, dtype=torch.long)},
                   device="cpu")
    assert ops.launch_counts()["rms_norm"] == 0
    counters = obs.snapshot()["counters"]
    obs.reset()
    assert "kernels.rms_norm.rows" not in counters
    assert "model.rms_norm.plain_rows" not in counters


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel builds and runs only there")
    return torch.device("cuda")


def _held(got, want, gated=False):
    assert got.shape == want.shape and got.dtype == want.dtype
    assert got.is_contiguous()
    if got.dtype == torch.bfloat16:
        steps = checks.bf16_steps(got, want)
        assert int(steps.max()) <= 1 + gated
        assert float((steps == 0).float().mean()) >= 0.999
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("tag", list(checks.RMS_NORM_CASES))
def test_kernel_against_the_plain_version(dev, tag):
    rows, d, dtype, gated = checks.RMS_NORM_CASES[tag]
    g = torch.Generator(device=dev).manual_seed(rows + d)
    x, gamma, z = checks.rms_norm_inputs(g, dev, rows, d, dtype, gated)
    ops.reset_launch_counts()
    got = ops.rms_norm(x, gamma, z)
    torch.cuda.synchronize()
    assert ops.launch_counts()["rms_norm"] == 1
    _held(got, ref.rms_norm_ref(x, gamma, z=z), gated)
    if gated:
        # the gate rounds as the plain expression: the kernel's own norm
        # times silu(z), to a step
        own = ops.rms_norm(x, gamma) * F.silu(z)
        _held(got, own)


@pytest.mark.cuda
def test_kernel_reads_a_transposed_view_and_decode_rows(dev):
    """Mamba2's y, (Bt, H, T, P) → (Bt, T, H·P) without a copy, and a
    (16, 1, d) decode batch, each as the plain version."""
    g = torch.Generator(device=dev).manual_seed(3)
    y = torch.randn(4, 64, 16, 32, generator=g, device=dev).bfloat16()
    y = y.transpose(1, 2)                     # (4, 16, 64, 32) view
    gamma = torch.rand(2048, generator=g, device=dev).bfloat16()
    rows = y.reshape(4, 16, 2048)
    _held(ops.rms_norm(rows, gamma), ref.rms_norm_ref(rows, gamma))
    step = torch.randn(16, 1, 3584, generator=g, device=dev).bfloat16()
    gamma = torch.rand(3584, generator=g, device=dev).bfloat16()
    _held(ops.rms_norm(step, gamma), ref.rms_norm_ref(step, gamma))


@pytest.mark.cuda
@pytest.mark.parametrize("name,per_layer", [("hubert-xlarge", 2),
                                            ("zamba2-7b", 2)])
def test_no_grad_features_take_the_kernel_and_no_plain_row(dev, name,
                                                           per_layer):
    cfg = get_config(name).reduced(n_layers=4 if name == "zamba2-7b"
                                   else 2, d_model=128)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    B, S = 3, 16
    batch = ({"frames": torch.randn(B, S, cfg.frame_embed_dim)}
             if cfg.family == "encoder" else
             {"tokens": torch.randint(1, cfg.vocab_size, (B, S))})
    uses = cfg.n_layers // cfg.attn_every if cfg.family == "hybrid" else 0
    calls = per_layer * cfg.n_layers + 2 * uses + 1
    ops.reset_launch_counts()
    obs.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        M.features(cfg, params, batch, device="cuda")
        torch.cuda.synchronize()
    counters = obs.snapshot()["counters"]
    obs.reset()
    assert ops.launch_counts()["rms_norm"] == calls
    assert counters["kernels.rms_norm.rows"] == calls * B * S
    assert "model.rms_norm.plain_rows" not in counters


@pytest.mark.cuda
def test_a_gradient_takes_the_plain_expression(dev):
    x, gamma, z = _inputs(64, 7168, torch.bfloat16, device=dev, gate=True)
    leaves = [t.clone().requires_grad_() for t in (x, gamma)]
    ops.reset_launch_counts()
    obs.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        got = layers.rms_norm(*leaves, z=z)
    counters = obs.snapshot()["counters"]
    obs.reset()
    got.float().square().sum().backward()
    plain = [t.clone().requires_grad_() for t in (x, gamma)]
    want = _plain(*plain) * F.silu(z)
    want.float().square().sum().backward()
    assert ops.launch_counts()["rms_norm"] == 0
    assert counters["model.rms_norm.plain_rows"] == 64
    assert "kernels.rms_norm.rows" not in counters
    assert torch.equal(got, want)
    for a, b in zip(leaves, plain):
        assert torch.equal(a.grad, b.grad)
    with pytest.raises(ValueError, match="no backward"):
        ops.rms_norm(*leaves, z)
