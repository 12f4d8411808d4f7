"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA card and skips without one.  The file imports
neither JAX nor the JAX package, so it also runs where only PyTorch is
installed (``tests/conftest.py`` imports JAX, hence ``--noconftest``):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_cuda.py

Tolerances: E-step 3e-4; attention 2e-3 in f32 and 5e-2 in bf16 (the
reference's own kernel bounds, ``tests/test_kernels.py``); wkv6 1e-4 and
ssd 2e-4 in f32 (``tests/test_wkv6_kernel.py``, ``tests/test_ssd_kernel.py``),
against the plain versions and, at the paths' head sizes and T = 200,
against the float64 step recurrence; 1e-2 in bf16, where kernel and plain
version each round one f32 result to bf16 (at most one bf16 step, 2^-8
relative, apart).  Flash attention's backward: ``kernels.checks``'s
``BWD_TOL_F32`` / ``BWD_TOL_BF16`` × each gradient's max; that of wkv6 and
ssd ``RECUR_BWD_TOL_F32`` / ``RECUR_BWD_TOL_BF16``.  The flash cases
over several key tiles compare the
rows with a visible key; bf16 layouts that the kernels cannot copy in
16-byte pieces raise ``ValueError`` without a launch.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import FOUNDATION_STANDIN, get_config
from repro_torch.kernels import attention_cached as CA
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import flash_attention_bwd as FAB
from repro_torch.kernels import gmm_estep as GE
from repro_torch.kernels import checks, ops, ref
from repro_torch.kernels import ssd as SSD
from repro_torch.kernels import ssd_bwd as SSDB
from repro_torch.kernels import wkv6 as WKV
from repro_torch.kernels import wkv6_bwd as WKVB
from repro_torch.models import model as M

pytestmark = pytest.mark.cuda

ESTEP_TOL = 3e-4
ATTN_CASES = [
    # B, H, Hkv, Sq, Sk, D, causal, window, prefix
    (1, 4, 4, 16, 16, 16, True, 0, 0),
    (2, 4, 2, 24, 24, 16, True, 0, 0),       # GQA
    (1, 2, 2, 20, 20, 16, True, 6, 0),       # sliding window
    (1, 4, 1, 8, 24, 16, True, 0, 0),        # MQA, queries at the tail
    (1, 2, 2, 24, 24, 80, False, 0, 0),      # bidirectional, D = 80
    (1, 4, 4, 24, 24, 16, True, 0, 5),       # bidirectional prefix
    (1, 2, 2, 24, 24, 16, True, 5, 3),       # window + prefix
    (1, 2, 2, 200, 200, 128, False, 0, 0),   # several key tiles, ragged
    (2, 4, 2, 70, 150, 64, True, 0, 0),      # ragged queries and keys
    (2, 4, 4, 200, 200, 112, True, 0, 0),    # causal D = 112 (zamba2-7b)
]


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    return torch.device("cuda")


def _estep_inputs(seed, Bx, B, N, K, d, spher, dev):
    rng = np.random.RandomState(seed)
    var_shape = (B, K) if spher else (B, K, d)
    logits = rng.randn(B, K)
    arrays = (rng.randn(Bx, N, d), rng.randn(B, K, d),
              np.log1p(np.exp(rng.randn(*var_shape))) + 0.1,
              np.exp(logits) / np.exp(logits).sum(-1, keepdims=True))
    return [torch.tensor(a, dtype=torch.float32, device=dev) for a in arrays]


@pytest.mark.parametrize("Bx,B,N,K,d,spher", [
    (1, 10, 1000, 10, 1280, False),          # the main path's client call
    (2, 6, 1001, 7, 130, True),              # ragged N and K, spher
    (3, 3, 5, 20, 33, False),                # K over one tile, tiny N
])
def test_estep_fused(dev, Bx, B, N, K, d, spher):
    args = _estep_inputs(1, Bx, B, N, K, d, spher, dev)
    lp, lse = GE.estep_fused(*args)
    elp, else_ = ref.estep_fused_ref(*args)
    torch.testing.assert_close(lp, elp, rtol=ESTEP_TOL, atol=ESTEP_TOL)
    torch.testing.assert_close(lse, else_, rtol=ESTEP_TOL, atol=ESTEP_TOL)


@pytest.mark.parametrize("tag", sorted(checks.ESTEP_CASES))
def test_estep_fused_check_cases(dev, tag):
    """The card checks' cases (``kernels.checks.ESTEP_CASES``): the path's
    and the cohort's shapes, K over several component tiles, K = 1, ragged
    N, K and d, spher."""
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    args = checks.estep_inputs(g, dev, *checks.ESTEP_CASES[tag])
    lp, lse = GE.estep_fused(*args)
    elp, else_ = ref.estep_fused_ref(*args)
    torch.testing.assert_close(lp, elp, rtol=ESTEP_TOL, atol=ESTEP_TOL)
    torch.testing.assert_close(lse, else_, rtol=ESTEP_TOL, atol=ESTEP_TOL)


def test_estep(dev):
    x, mu, var, pi = (a[0] for a in _estep_inputs(2, 1, 1, 300, 10, 96,
                                                  False, dev))
    torch.testing.assert_close(GE.estep(x, mu, var, pi),
                               ref.estep_ref(x, mu, var, pi),
                               rtol=ESTEP_TOL, atol=ESTEP_TOL)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-3),
                                       (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,D,causal,window,prefix", ATTN_CASES)
def test_flash_attention(dev, B, H, Hkv, Sq, Sk, D, causal, window, prefix,
                         dtype, tol):
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    q, k, v = (torch.randn(B, h, S, D, generator=g, device=dev).to(dtype)
               for h, S in ((H, Sq), (Hkv, Sk), (Hkv, Sk)))
    kw = dict(causal=causal, window=window, prefix=prefix)
    out = FA.flash_attention(q, k, v, **kw)
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out, ref.attention_ref(q, k, v, **kw),
                               rtol=tol, atol=tol)


# the bf16 kernel's tile skipping over several key tiles of 64
SKIP_CASES = [
    # B, H, Hkv, Sq, Sk, D, causal, window, prefix
    (1, 4, 2, 512, 512, 112, True, 0, 0),    # causal S = 512, GQA, D = 112
    (1, 2, 2, 512, 512, 64, True, 100, 0),   # tiles skipped on both sides
    (1, 2, 2, 512, 512, 64, True, 0, 130),   # a prefix over two tiles
    (1, 4, 2, 1, 515, 64, True, 0, 0),       # one query at the tail
    (1, 4, 2, 70, 515, 112, True, 0, 0),     # 70 queries at the tail
    (2, 2, 2, 200, 200, 80, False, 0, 0),    # bidirectional, ragged Sk
]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-3),
                                       (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,D,causal,window,prefix", SKIP_CASES)
def test_flash_attention_tile_skipping(dev, B, H, Hkv, Sq, Sk, D, causal,
                                       window, prefix, dtype, tol):
    """Against the plain version on the rows with a visible key (the plain
    version gives a row with none the mean of v, the kernels 0)."""
    g = torch.Generator(device=dev)
    g.manual_seed(Sq + Sk + window + prefix)
    q, k, v = (torch.randn(B, h, S, D, generator=g, device=dev).to(dtype)
               for h, S in ((H, Sq), (Hkv, Sk), (Hkv, Sk)))
    kw = dict(causal=causal, window=window, prefix=prefix)
    rows = ref.attention_mask(Sq, Sk, device=dev, **kw).any(-1)
    out = FA.flash_attention(q, k, v, **kw)
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out[:, :, rows],
                               ref.attention_ref(q, k, v, **kw)[:, :, rows],
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-3),
                                       (torch.bfloat16,
                                        checks.FLASH_TOL_BF16)])
@pytest.mark.parametrize("tag", sorted(checks.FLASH_CASES))
def test_flash_attention_check_cases(dev, tag, dtype, tol):
    """The chip smoke's wide-head and MQA shapes
    (``kernels.checks.FLASH_CASES``): pixtral-12b's D = 160,
    nemotron-4-340b's D = 192, granite-34b's group of 48."""
    B, H, Hkv, Sq, Sk, D, causal = checks.FLASH_CASES[tag]
    g = torch.Generator(device=dev)
    g.manual_seed(D + H)
    q, k, v = (torch.randn(B, h, S, D, generator=g, device=dev).to(dtype)
               for h, S in ((H, Sq), (Hkv, Sk), (Hkv, Sk)))
    out = FA.flash_attention(q, k, v, causal=causal)
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out, ref.attention_ref(q, k, v,
                                                      causal=causal),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("layout", ["base", "row_stride"])
def test_flash_attention_refuses_misaligned_bf16_views(dev, layout):
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    if layout == "base":     # a base 2 bytes past a 16-byte boundary
        flat = torch.randn(2 * 64 * 80 + 1, generator=g, device=dev)
        q = flat.to(torch.bfloat16)[1:].view(1, 2, 64, 80)
    else:                    # rows 84 elements (168 bytes) apart
        q = torch.randn(1, 2, 64, 84, generator=g, device=dev) \
            .to(torch.bfloat16)[..., :80]
    k = torch.randn(1, 2, 64, 80, generator=g, device=dev).to(torch.bfloat16)
    before = FA.LAUNCHES["flash_attention"]
    with pytest.raises(ValueError, match="16-byte"):
        FA.flash_attention(q, k, k, causal=False)
    assert FA.LAUNCHES["flash_attention"] == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rows_with_no_visible_key_are_zero(dev, dtype):
    q = torch.randn(1, 2, 8, 32, device=dev).to(dtype)
    k = torch.randn(1, 2, 4, 32, device=dev).to(dtype)
    out = FA.flash_attention(q, k, k, causal=True)
    assert float(out[:, :, :4].abs().max()) == 0.0


@pytest.mark.parametrize("dtype,tol", [(torch.float32, checks.BWD_TOL_F32),
                                       (torch.bfloat16, checks.BWD_TOL_BF16)])
@pytest.mark.parametrize("tag", sorted(checks.BWD_CASES))
def test_flash_attention_bwd(dev, tag, dtype, tol):
    """The backward kernel's dq, dk, dv against ``ref.attention_bwd_ref``
    on the forward kernel's o and lse, each within tol × its max
    (``kernels.checks``), and the lse against ``ref.attention_lse_ref``;
    rows with no visible key get dq = 0 exactly."""
    B, H, Hkv, Sq, Sk, D, causal, window, prefix = checks.BWD_CASES[tag]
    g = torch.Generator(device=dev)
    g.manual_seed(Sq + Sk + D)
    q, k, v, do = checks.bwd_inputs(g, dev, B, H, Hkv, Sq, Sk, D, dtype)
    kw = dict(causal=causal, window=window, prefix=prefix)
    o, lse = FA.flash_attention(q, k, v, return_lse=True, **kw)
    torch.testing.assert_close(lse, ref.attention_lse_ref(q, k, **kw),
                               rtol=2e-3, atol=2e-3)
    before = FAB.LAUNCHES["flash_attention_bwd"]
    got = FAB.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    assert FAB.LAUNCHES["flash_attention_bwd"] == before + 1
    exp = ref.attention_bwd_ref(q, k, v, o, lse, do, **kw)
    for name, a, e in zip(("dq", "dk", "dv"), got, exp):
        assert a.dtype == dtype and a.shape == e.shape, name
        err = float((a.float() - e.float()).abs().max())
        assert err <= tol * float(e.float().abs().max()), (name, err)
    rows = ref.attention_mask(Sq, Sk, device=dev, **kw).any(-1)
    assert float(got[0][:, :, ~rows].abs().sum()) == 0.0


@pytest.mark.parametrize("causal,window,prefix", [(True, 0, 0),
                                                  (False, 0, 0),
                                                  (True, 9, 4)])
def test_ops_attention_gradient_through_the_kernels(dev, causal, window,
                                                    prefix):
    """``ops.attention`` with grad on CUDA runs the forward and backward
    kernels: f32 gradients equal autograd of the plain version within
    2e-3 × their max, and no plain version runs on the card."""
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    q, k, v, do = checks.bwd_inputs(g, dev, 2, 4, 2, 150, 150, 64,
                                    torch.float32)
    kw = dict(causal=causal, window=window, prefix=prefix)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    ops.reset_launch_counts()
    ops.attention(*leaves, **kw).backward(do)
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 1
    assert counts["flash_attention_bwd"] == 1
    assert not any(n for key, n in counts.items()
                   if key.startswith("plain_on_cuda"))
    plain = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    ref.attention_ref(*plain, **kw).backward(do)
    for a, e in zip(leaves, plain):
        err = float((a.grad - e.grad).abs().max())
        assert err <= 2e-3 * float(e.grad.abs().max())


def test_flash_attention_bwd_is_deterministic(dev):
    """Two calls of the bf16 backward at granite-3-2b's training shape give
    the same bits: no atomics, every sum in one fixed order."""
    B, H, Hkv, Sq, Sk, D, causal, _, _ = checks.BWD_CASES["granite_train"]
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    q, k, v, do = checks.bwd_inputs(g, dev, B, H, Hkv, Sq, Sk, D,
                                    torch.bfloat16)
    o, lse = FA.flash_attention(q, k, v, causal=causal, return_lse=True)
    first = FAB.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    second = FAB.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


def test_flash_attention_bwd_copies_a_do_it_cannot_read(dev):
    """A bf16 ``do`` with a row stride that is no multiple of 16 bytes
    (autograd makes it, not the caller) is copied, not refused: the same
    bits as from a contiguous one; a misaligned q raises."""
    g = torch.Generator(device=dev)
    g.manual_seed(12)
    q, k, v, do = checks.bwd_inputs(g, dev, 2, 4, 2, 100, 100, 64,
                                    torch.bfloat16)
    o, lse = FA.flash_attention(q, k, v, return_lse=True)
    wide = torch.zeros(2, 4, 100, 65, dtype=torch.bfloat16, device=dev)
    wide[..., :64] = do
    odd = wide[..., :64]
    assert odd.stride(2) % 8
    for a, b in zip(FAB.flash_attention_bwd(q, k, v, o, lse, odd),
                    FAB.flash_attention_bwd(q, k, v, o, lse,
                                            do.contiguous())):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="16-byte"):
        FAB.flash_attention_bwd(odd, k, v, o, lse, do)


def test_refusals_without_a_backward_kernel(dev):
    """``wkv6`` / ``ssd`` with grad on CUDA (which raised before their
    backward kernels existed) launch their forward kernel once and their
    backward kernel once, and no plain version."""
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    for kernel, dims in (("wkv6", (1, 2, 64, 64)), ("ssd", (1, 2, 64, 16, 64))):
        args, dout, _ = checks.recur_bwd_inputs(g, dev, kernel, dims,
                                                torch.bfloat16, 1.0)
        leaves = [a.detach().clone().requires_grad_() for a in args]
        ops.reset_launch_counts()
        out, _ = getattr(ops, kernel)(*leaves)
        out.backward(dout)
        counts = ops.launch_counts()
        assert counts[kernel] == 1 and counts[f"{kernel}_bwd"] == 1, counts
        assert not any(n for key, n in counts.items()
                       if key.startswith("plain_on_cuda"))
        assert all(t.grad is not None for t in leaves)


# kernel: (its backward's wrapper, plain forward, plain backward, the
# gradients' names)
_RECUR = {"wkv6": (WKVB.wkv6_bwd, ref.wkv6_ref, ref.wkv6_bwd_ref,
                   ("dr", "dk", "dv", "dlw", "du", "dS0")),
          "ssd": (SSDB.ssd_bwd, ref.ssd_ref, ref.ssd_bwd_ref,
                  ("dx", "da_log", "dB", "dC", "dS0"))}


@pytest.mark.parametrize("dtype,tol", [
    (torch.float32, checks.RECUR_BWD_TOL_F32),
    (torch.bfloat16, checks.RECUR_BWD_TOL_BF16)])
@pytest.mark.parametrize("tag", sorted(checks.RECUR_BWD_CASES))
def test_recurrent_bwd_check_cases(dev, tag, dtype, tol):
    """The wkv6 / ssd backward kernels at ``kernels.checks.RECUR_BWD_CASES``
    against their plain versions and against autograd of the plain
    forwards, every gradient within tol × its max; gradients in their
    inputs' dtypes."""
    kernel, dims, chunk, scale, fill = checks.RECUR_BWD_CASES[tag]
    g = torch.Generator(device=dev)
    g.manual_seed(sum(dims))
    args, dout, dS = checks.recur_bwd_inputs(g, dev, kernel, dims, dtype,
                                             scale, fill)
    fn, fwd, plain, names = _RECUR[kernel]
    got = fn(*args, dout, dS)
    exp = plain(*args, dout, dS)
    leaves = [a.detach().clone().requires_grad_() for a in args]
    out, S = fwd(*leaves, chunk=chunk)
    torch.autograd.backward((out, S) if dS is not None else out,
                            (dout, dS) if dS is not None else dout)
    for name, a, e, leaf in zip(names, got, exp, leaves):
        assert a.dtype == e.dtype and a.shape == e.shape, name
        assert bool(torch.isfinite(a).all()), name
        for want in (e, leaf.grad):
            err = float((a.float() - want.float()).abs().max())
            assert err <= tol * float(want.float().abs().max()), (name, err)


@pytest.mark.parametrize("tag", ["rwkv6_train", "zamba2_train"])
def test_recurrent_bwd_is_deterministic(dev, tag):
    """Two calls of a bf16 backward at a training shape give the same
    bits: no atomics, every sum in one fixed order."""
    kernel, dims, _, scale, fill = checks.RECUR_BWD_CASES[tag]
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    args, dout, dS = checks.recur_bwd_inputs(g, dev, kernel, dims,
                                             torch.bfloat16, 1.0, fill)
    fn = _RECUR[kernel][0]
    for a, b in zip(fn(*args, dout, dS), fn(*args, dout, dS)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kernel", ["wkv6", "ssd"])
def test_ops_recurrent_gradient_through_the_kernels(dev, kernel):
    """``ops.wkv6`` / ``ops.ssd`` with grad on CUDA, f32, a nonzero s0 and
    a loss on both outputs: every input's gradient equals autograd of the
    plain version on the same inputs within 1e-3 × its max; a d_out whose
    last dim is strided is copied, not refused."""
    dims = (2, 3, 70, 32) if kernel == "wkv6" else (2, 3, 70, 16, 32)
    g = torch.Generator(device=dev)
    g.manual_seed(9)
    args, dout, dS = checks.recur_bwd_inputs(g, dev, kernel, dims,
                                             torch.float32, 1.0)
    grads = []
    for fn in (getattr(ops, kernel), _RECUR[kernel][1]):
        leaves = [a.detach().clone().requires_grad_() for a in args]
        out, S = fn(*leaves)
        # two passes: the card's backward once with each output's gradient
        # absent
        (out * dout).sum().backward(retain_graph=True)
        (S * dS).sum().backward()
        grads.append([t.grad for t in leaves])
    for a, e in zip(*grads):
        err = float((a - e).abs().max())
        assert err <= 1e-3 * float(e.abs().max())
    wide = torch.zeros(*dout.shape, 2, device=dev)
    wide[..., 0] = dout
    odd = wide[..., 0]
    assert odd.stride(-1) == 2
    fn = _RECUR[kernel][0]
    for a, b in zip(fn(*args, odd, dS), fn(*args, dout.contiguous(), dS)):
        assert torch.equal(a, b)


# cached attention over per-row positions: kind, (B, Sq, Sk), window
CACHED_GRID = [("ragged", (4, 1, 300), 0),      # dense decode, lengths 1…300
               ("ragged", (3, 1, 300), 40),     # … under a window
               ("ring", (4, 1, 96), 96),        # a wrapped ring, decode
               ("chunk", (2, 64, 96), 96)]      # a ring prefill chunk


# bf16: the kernel and the plain version each round an f32 result to
# bf16 (the chip smoke measured at most 1e-3 at outputs up to 1.6)
CACHED_TOL = [(torch.float32, 2e-3), (torch.bfloat16, 1e-2)]


def _check_cached(dev, kind, dims, window, G, D, dtype, tol, seed):
    """One ``attention_cached`` call against ``ref.attention_positions_ref``
    on the rows with a visible key (the plain version gives a row with
    none the mean of v, the kernel 0, checked on those rows)."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    B, Sq, Sk = dims
    Hkv = 2
    q, k, v, q_pos, kv_pos = checks.cached_inputs(
        g, dev, B, G * Hkv, Hkv, Sq, Sk, D, window, kind, dtype)
    before = CA.LAUNCHES["attention_cached"]
    out = CA.attention_cached(q, k, v, q_pos, kv_pos, window=window)
    assert CA.LAUNCHES["attention_cached"] == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    seen = ref.positions_mask(q_pos, kv_pos, window=window).any(-1)
    exp = ref.attention_positions_ref(q, k, v, q_pos, kv_pos, window=window)
    sel = seen[:, None, :].expand(out.shape[:3])
    torch.testing.assert_close(out[sel], exp[sel], rtol=tol, atol=tol)
    if (~sel).any():
        assert float(out[~sel].abs().max()) == 0.0


@pytest.mark.parametrize("dtype,tol", CACHED_TOL)
@pytest.mark.parametrize("D", [64, 112, 128, 160, 192])
@pytest.mark.parametrize("G", [1, 4, 16, 17, 48, 64, 65])
@pytest.mark.parametrize("kind,dims,window", CACHED_GRID)
def test_attention_cached(dev, kind, dims, window, G, D, dtype, tol):
    """Against ``ref.attention_positions_ref`` (the key ranges split as
    ``split_plan`` gives them on this card).  At Sq = 1 a kv head's group
    is G rows: 16 and 17 sit on either side of the bf16 kernel's
    four-way key slices, 64 and 65 on either side of one block."""
    _check_cached(dev, kind, dims, window, G, D, dtype, tol, D + G)


def _mixed_ring(dev, B, G, dtype):
    """A cache of four 64-slot tiles read by three queries at 1000-1002
    under window 200, so that each tile takes another class for the bf16
    kernel: empty (skip), a wrapped run 900-963 (full), a wrapped run
    964-1027 (masked: some slots past the causal end), 100-163 (skip:
    behind the window); the rows' order of tiles is rolled by b."""
    Hkv, Sq, D = 2, 3, 64
    g = torch.Generator(device=dev)
    g.manual_seed(B * G)
    j = torch.arange(64, device=dev)
    tiles = [torch.full((64,), -1, device=dev), 900 + (j + 17) % 64,
             964 + (j + 40) % 64, 100 + (j + 5) % 64]
    kv_pos = torch.stack([torch.cat(tiles[b % 4:] + tiles[:b % 4])
                          for b in range(B)]).int()
    q_pos = (1000 + torch.arange(Sq, device=dev)).expand(B, Sq).int()
    q = torch.randn(B, Sq, G * Hkv, D, generator=g, device=dev).to(dtype)
    k, v = (torch.randn(B, 256, Hkv, D, generator=g, device=dev).to(dtype)
            for _ in range(2))
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), q_pos, \
        kv_pos


@pytest.mark.parametrize("dtype,tol", CACHED_TOL)
@pytest.mark.parametrize("G", [4, 20])
def test_attention_cached_mixed_tiles(dev, G, dtype, tol):
    """A wrapped ring whose tiles are skipped, full and masked (G = 4: 12
    rows, one row group; G = 20: 60 rows, four), unsplit and split."""
    q, k, v, q_pos, kv_pos = _mixed_ring(dev, 4, G, dtype)
    for tile in range(4):
        classes = {CA.tile_class(kv_pos[b, 64 * tile:64 * (tile + 1)],
                                 1000, 1002, True, 200) for b in range(4)}
        assert len(classes) == 3   # each tile is each class in some row
    exp = ref.attention_positions_ref(q, k, v, q_pos, kv_pos, window=200)
    for plan in ((256, 1), (64, 4)):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(CA, "split_plan", lambda *a: plan)
            out = CA.attention_cached(q, k, v, q_pos, kv_pos, window=200)
        torch.testing.assert_close(out, exp, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,tol", CACHED_TOL)
def test_attention_cached_splits_with_rows_that_see_nothing(dev, dtype, tol):
    """Eight key ranges of 64 over rows of length 1, 100 and 300 and a row
    with no valid slot: most splits see no key of a row (m = -inf in
    their partial result), the last row none at all (exactly 0)."""
    B, G, Hkv, Sk, D = 4, 4, 2, 512, 128
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    length = torch.tensor([1, 100, 300, 0], device=dev)[:, None]
    j = torch.arange(Sk, device=dev)[None]
    kv_pos = torch.where(j < length, j, -1).int()
    q_pos = (length - 1).clamp_min(0).int()
    q = torch.randn(B, 1, G * Hkv, D, generator=g, device=dev).to(dtype)
    k, v = (torch.randn(B, Sk, Hkv, D, generator=g, device=dev).to(dtype)
            for _ in range(2))
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(CA, "_sm_count", lambda index: 10_000)
        assert CA.split_plan(B, G * Hkv, Hkv, 1, Sk, 10_000) == (64, 8)
        out = CA.attention_cached(q, k, v, q_pos, kv_pos)
    exp = ref.attention_positions_ref(q, k, v, q_pos, kv_pos)
    torch.testing.assert_close(out[:3], exp[:3], rtol=tol, atol=tol)
    assert float(out[3].abs().max()) == 0.0


@pytest.mark.parametrize("dtype,tol", CACHED_TOL)
@pytest.mark.parametrize("kind,dims,window",
                         CACHED_GRID + [("prefill", (1, 200, 96), 96)])
def test_attention_cached_unsplit(dev, monkeypatch, kind, dims, window,
                                  dtype, tol):
    """The branch that writes the output straight from the block (one key
    range, no combine pass): forced by planning for a card of one SM."""
    monkeypatch.setattr(CA, "_sm_count", lambda index: 1)
    B, Sq, Sk = dims
    n_keys = Sk + Sq if kind in ("chunk", "prefill") else Sk
    assert CA.split_plan(B, 8, 2, Sq, n_keys, 1)[1] == 1
    _check_cached(dev, kind, dims, window, 4, 64, dtype, tol, 5)


@pytest.mark.parametrize("tag", sorted(checks.CACHED_CASES))
def test_attention_cached_check_cases(dev, tag):
    """The chip smoke's shapes (granite-3-2b's and zamba2-7b's decode, a
    wrapped ring, a ring chunk, the ring server's unsplit prefill), bf16."""
    B, H, Hkv, Sq, Sk, D, window, kind = checks.CACHED_CASES[tag]
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    q, k, v, q_pos, kv_pos = checks.cached_inputs(
        g, dev, B, H, Hkv, Sq, Sk, D, window, kind, torch.bfloat16)
    out = CA.attention_cached(q, k, v, q_pos, kv_pos, window=window)
    seen = ref.positions_mask(q_pos, kv_pos, window=window).any(-1)
    sel = seen[:, None, :].expand(out.shape[:3])
    exp = ref.attention_positions_ref(q, k, v, q_pos, kv_pos, window=window)
    torch.testing.assert_close(out[sel], exp[sel], rtol=1e-2, atol=1e-2)


def test_attention_cached_refuses_what_it_cannot_run(dev):
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    q, k, v, q_pos, kv_pos = checks.cached_inputs(
        g, dev, 2, 4, 2, 1, 64, 64, 0, "ragged", torch.bfloat16)
    before = CA.LAUNCHES["attention_cached"]
    with pytest.raises(ValueError, match="CUDA"):
        CA.attention_cached(q.cpu(), k.cpu(), v.cpu(), q_pos.cpu(),
                            kv_pos.cpu())
    with pytest.raises(ValueError, match="share"):
        CA.attention_cached(q.half(), k.half(), v.half(), q_pos, kv_pos)
    with pytest.raises(ValueError, match="kv_pos"):
        CA.attention_cached(q, k, v, q_pos, kv_pos[:, :32])
    with pytest.raises(ValueError, match="integers"):
        CA.attention_cached(q, k, v, q_pos.float(), kv_pos)
    flat = torch.randn(k.numel() + 1, generator=g, device=dev)
    shifted = flat.to(torch.bfloat16)[1:].view(k.shape)  # base 2 B past 16
    with pytest.raises(ValueError, match="16-byte"):
        CA.attention_cached(q, shifted, v, q_pos, kv_pos)
    assert CA.LAUNCHES["attention_cached"] == before


@pytest.mark.parametrize("B,H,T,Dh,chunk,dtype,tol", [
    *(c + (torch.float32, 1e-4) for c in checks.WKV6_SHAPES),
    (2, 2, 128, 64, 32, torch.bfloat16, 1e-2),
    (2, 2, 200, 64, 64, torch.bfloat16, 1e-2),
])
def test_wkv6(dev, B, H, T, Dh, chunk, dtype, tol):
    g = torch.Generator(device=dev)
    g.manual_seed(T + Dh)
    args = checks.wkv6_inputs(g, dev, B, H, T, Dh, dtype)
    out, sf = WKV.wkv6(*args, chunk=chunk)
    exp, sf_exp = ref.wkv6_ref(*args, chunk=chunk)
    assert out.dtype == dtype and sf.dtype == torch.float32
    torch.testing.assert_close(out, exp, rtol=tol, atol=tol)
    torch.testing.assert_close(sf, sf_exp, rtol=tol, atol=tol)


@pytest.mark.parametrize("tag,dims,chunk,s0_scale,fill", checks.WKV6_BF16,
                         ids=[c[0] for c in checks.WKV6_BF16])
def test_wkv6_bf16_tensor_cores(dev, tag, dims, chunk, s0_scale, fill):
    """The card checks' bf16 cases (``kernels.checks.WKV6_BF16``): the
    path's shape, T = 200, lw ≡ −8 and lw ≡ 0."""
    g = torch.Generator(device=dev)
    g.manual_seed(dims[2])
    kw = {} if fill is None else {"lw_fill": fill}
    args = checks.wkv6_inputs(g, dev, *dims, torch.bfloat16, s0_scale,
                              model_like=tag == "main" or fill is not None,
                              **kw)
    out, sf = WKV.wkv6(*args, chunk=chunk)
    exp, sf_exp = ref.wkv6_ref(*args, chunk=chunk)
    assert out.dtype == torch.bfloat16 and sf.dtype == torch.float32
    torch.testing.assert_close(out, exp, rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(sf, sf_exp, rtol=1e-2, atol=1e-2)


def test_wkv6_refuses_misaligned_bf16_views(dev):
    """r rows 68 elements (136 bytes) apart: not 16-byte pieces."""
    g = torch.Generator(device=dev)
    g.manual_seed(6)
    r, k, v, lw, u, s0 = checks.wkv6_inputs(g, dev, 1, 2, 64, 64,
                                            torch.bfloat16)
    wide = torch.zeros(1, 2, 64, 68, device=dev, dtype=torch.bfloat16)
    wide[..., :64] = r
    before = WKV.LAUNCHES["wkv6"]
    with pytest.raises(ValueError, match="16-byte"):
        WKV.wkv6(wide[..., :64], k, v, lw, u, s0)
    assert WKV.LAUNCHES["wkv6"] == before


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("Bt,H,T,N,P,chunk", checks.SSD_SHAPES)
def test_ssd(dev, Bt, H, T, N, P, chunk, dtype, tol):
    g = torch.Generator(device=dev)
    g.manual_seed(T + N)
    args = checks.ssd_inputs(g, dev, Bt, H, T, N, P, dtype)
    y, sf = SSD.ssd(*args, chunk=chunk)
    exp, sf_exp = ref.ssd_ref(*args, chunk=chunk)
    assert y.dtype == dtype and sf.dtype == torch.float32
    torch.testing.assert_close(y, exp, rtol=tol, atol=tol)
    torch.testing.assert_close(sf, sf_exp, rtol=tol, atol=tol)


@pytest.mark.parametrize("Bt,H,T,N,P,s0_scale,model_like", [
    (64, 112, 512, 64, 64, 1.0, True),   # the path's shape, nonzero s0
    (2, 3, 200, 64, 64, 1.0, False),     # ragged last chunk of 64
    (2, 3, 65, 64, 64, 1.0, False),      # one step into the second chunk
])
def test_ssd_bf16_tensor_cores(dev, Bt, H, T, N, P, s0_scale, model_like):
    g = torch.Generator(device=dev)
    g.manual_seed(T)
    args = checks.ssd_inputs(g, dev, Bt, H, T, N, P, torch.bfloat16,
                             s0_scale, model_like=model_like)
    y, sf = SSD.ssd(*args, chunk=256)
    exp, sf_exp = ref.ssd_ref(*args, chunk=256)
    assert y.dtype == torch.bfloat16 and sf.dtype == torch.float32
    torch.testing.assert_close(y, exp, rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(sf, sf_exp, rtol=1e-2, atol=1e-2)


def test_ssd_refuses_misaligned_bf16_views(dev):
    """x rows 68 elements (136 bytes) apart: not 16-byte pieces."""
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    x, a, Bm, Cm, s0 = checks.ssd_inputs(g, dev, 1, 2, 64, 16, 64,
                                         torch.bfloat16)
    wide = torch.zeros(1, 2, 64, 68, device=dev, dtype=torch.bfloat16)
    wide[..., :64] = x
    before = SSD.LAUNCHES["ssd"]
    with pytest.raises(ValueError, match="16-byte"):
        SSD.ssd(wide[..., :64], a, Bm, Cm, s0)
    assert SSD.LAUNCHES["ssd"] == before


@pytest.mark.parametrize("name", ["wkv6", "ssd"])
def test_long_f32_matches_the_float64_steps(dev, name):
    """The paths' head sizes (Dh = 64; N = P = 64) at T = 200, which no
    chunk divides, in f32 against the step recurrence in float64."""
    g = torch.Generator(device=dev)
    g.manual_seed(200)
    if name == "wkv6":
        *shape, chunk = checks.WKV6_LONG
        args = checks.wkv6_inputs(g, dev, *shape)
        got = WKV.wkv6(*args, chunk=chunk)
        exp = checks.wkv6_steps(*(a.double() for a in args))
        tol = 1e-4
    else:
        *shape, chunk = checks.SSD_LONG
        args = checks.ssd_inputs(g, dev, *shape)
        got = SSD.ssd(*args, chunk=chunk)
        exp = checks.ssd_steps(*(a.double() for a in args))
        tol = 2e-4
    for a, b in zip(got, exp):
        torch.testing.assert_close(a.double(), b, rtol=tol, atol=tol)


@pytest.mark.parametrize("name,over", [("rwkv6-3b", {}),
                                       ("zamba2-7b", {"n_layers": 5})])
def test_backbone_features_on_card_match_the_cpu_path(dev, name, over):
    """rwkv6-3b / zamba2-7b cut down through the wkv6 / ssd / flash
    kernels on the card against the plain CPU path, same weights."""
    cfg = get_config(name).reduced(**over)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    params = M.init_params(cfg, g, device=dev)
    tokens = torch.randint(1, cfg.vocab_size, (3, 72), device=dev)
    ops.reset_launch_counts()
    on_card = M.features(cfg, params, {"tokens": tokens})
    counts = ops.launch_counts()
    if cfg.family == "ssm":
        assert counts["wkv6"] == cfg.n_layers
    else:
        assert counts["ssd"] == cfg.n_layers
        assert counts["flash_attention"] == cfg.n_layers // cfg.attn_every
    assert not any(v for k, v in counts.items() if k.startswith("plain"))
    cpu = {k: ({kk: vv.cpu() for kk, vv in v.items()}
               if isinstance(v, dict) else v.cpu())
           for k, v in params.items()}
    on_cpu = M.features(cfg, cpu, {"tokens": tokens.cpu()}, device="cpu")
    torch.testing.assert_close(on_card.cpu(), on_cpu, rtol=5e-2, atol=5e-2)


def test_features_on_card_match_the_cpu_path(dev):
    """The encoder through the flash kernel on the card against the plain
    CPU path with the same weights: counted launches, no plain version."""
    cfg = dataclasses.replace(FOUNDATION_STANDIN, n_layers=2)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    params = M.init_params(cfg, g, device=dev)
    frames = torch.randn(3, 8, cfg.frame_embed_dim, generator=g, device=dev)
    ops.reset_launch_counts()
    on_card = M.features(cfg, params, {"frames": frames})
    counts = ops.launch_counts()
    assert counts["flash_attention"] == cfg.n_layers
    assert counts["plain_on_cuda.attention"] == 0
    cpu = {k: v.cpu() for k, v in params.items() if k != "blocks"}
    cpu["blocks"] = {k: v.cpu() for k, v in params["blocks"].items()}
    on_cpu = M.features(cfg, cpu, {"frames": frames.cpu()}, device="cpu")
    torch.testing.assert_close(on_card.cpu(), on_cpu, rtol=5e-2, atol=5e-2)


def test_grouped_full_noise_matches_the_gathered_form_on_card(dev):
    """Full-covariance draws grouped by (slot, component) on the card
    against the gathered form (one d × d factor per draw) at d = 64."""
    from repro_torch.core import gmm as G
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    Gs, K, d = 6, 3, 64
    a = torch.randn(Gs, K, d, d, generator=g, device=dev)
    fac = G.sampling_factor(a @ a.transpose(-1, -2) / d, "full")
    mu = torch.randn(Gs, K, d, generator=g, device=dev)
    slot = torch.randint(0, Gs, (8, 64), generator=g, device=dev)
    comp = torch.randint(0, K, (8, 64), generator=g, device=dev)
    eps = torch.randn(8, 64, d, generator=g, device=dev)
    got = G.slot_gaussian(slot, comp, eps, mu, fac, "full")
    exp = mu[slot, comp] + G.colored_noise(fac[slot, comp], eps, "full")
    torch.testing.assert_close(got, exp, rtol=1e-4, atol=1e-4)


def test_full_covariance_fit_on_card_matches_the_cpu_path(dev):
    """A full-covariance classwise fit (Cholesky E-step, batched M-step
    products) on the card against the port's CPU path, the same draws;
    the fit tolerance 2e-3 (tests/test_gmm.py)."""
    from repro_torch.core import gmm as G
    g = torch.Generator()
    g.manual_seed(3)
    C, K, N, d = 4, 2, 400, 32
    labels = torch.randint(0, C, (N,), generator=g)
    x = torch.randn(N, d, generator=g) + 3.0 * torch.eye(C, d)[labels]
    idx = torch.randint(0, N, (C, K), generator=g)
    jit = torch.randn(C, K, d, generator=g)
    cfg = G.GMMConfig(n_components=K, cov_type="full", n_iter=10)
    on_cpu = G.fit_classwise_gmms(x, labels, C, cfg, device="cpu",
                                  init_idx=idx, jitter=jit)
    on_card = G.fit_classwise_gmms(x, labels, C, cfg, device="cuda",
                                   init_idx=idx, jitter=jit)
    for f in ("pi", "mu", "cov"):
        torch.testing.assert_close(on_card[0][f].cpu(), on_cpu[0][f],
                                   rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(on_card[2].cpu(), on_cpu[2], rtol=2e-3,
                               atol=2e-3)


# ---------------------------------------------------------------------------
# the round-program cache: one captured CUDA graph per canonical signature
# ---------------------------------------------------------------------------


def _wire_cohort(seed, M, C, K, d, dev):
    from repro_torch.fl import round as FR
    rng = np.random.RandomState(seed)
    pi = rng.dirichlet(np.ones(K), (M, C)).astype(np.float32)
    mu = (rng.randn(M, C, K, d) + 3 * np.eye(C, d)[None, :, None]) \
        .astype(np.float32)
    cov = (rng.rand(M, C, K, d) + 0.1).astype(np.float32)
    counts = rng.randint(50, 150, (M, C)).astype(np.int32)
    sig = FR.CohortSignature(M=M, C=C, K=K, d=d, cov_type="diag")
    wire = [torch.from_numpy(a).to(dev, torch.bfloat16)
            for a in (pi, mu, cov)]
    return sig, (*wire, torch.from_numpy(counts).to(dev))


def _gen(dev, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g


@pytest.mark.parametrize("d,n_steps", [(64, 60), (1280, 500)])
def test_replay_is_bitwise_the_eager_round(dev, d, n_steps):
    """Same seed, same inputs: the replayed head, losses and final
    generator state are the eager ``round_program``'s, bit for bit; the
    capture did not fall back."""
    from repro_torch.core import head as H
    from repro_torch.fl import round as FR
    from repro_torch.launch import aot_cache as AC
    cfg = H.HeadConfig(n_steps=n_steps)
    sig, args = _wire_cohort(0, 4, 10, 10, d, dev)
    g_eager = _gen(dev, 7)
    head, losses = FR.round_program(*args, sig=sig, head_cfg=cfg,
                                    generator=g_eager)
    cache = AC.ProgramCache()
    prog = cache.get(sig, cfg, device="cuda")
    assert prog.aot and prog.eager_reason is None
    g_replay = _gen(dev, 7)
    rhead, rlosses = prog(*args, generator=g_replay)
    for k in ("w", "b"):
        assert torch.equal(rhead[k], head[k])
    assert torch.equal(rlosses, losses)
    assert torch.equal(g_replay.get_state(), g_eager.get_state())
    st = cache.stats()
    assert st["compiles"] == 1 and st["jit_fallbacks"] == 0


def test_two_rounds_on_one_entry_leave_the_first_head(dev):
    from repro_torch.core import head as H
    from repro_torch.launch import aot_cache as AC
    cfg = H.HeadConfig(n_steps=40)
    sig, first_args = _wire_cohort(0, 4, 10, 8, 64, dev)
    _, second_args = _wire_cohort(1, 4, 10, 8, 64, dev)
    prog = AC.ProgramCache().get(sig, cfg, device="cuda")
    first, _ = prog(*first_args, generator=_gen(dev, 1))
    kept = {k: v.clone() for k, v in first.items()}
    second, _ = prog(*second_args, generator=_gen(dev, 1))
    assert not torch.equal(second["w"], first["w"])
    for k in ("w", "b"):
        assert torch.equal(first[k], kept[k])


def test_eviction_frees_the_entry(dev):
    import gc

    from repro_torch.core import head as H
    from repro_torch.launch import aot_cache as AC

    def settled():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return torch.cuda.memory_allocated(), torch.cuda.memory_reserved()

    cfg = H.HeadConfig(n_steps=100)
    big, _ = _wire_cohort(0, 8, 10, 10, 1280, dev)
    small, _ = _wire_cohort(0, 1, 2, 1, 8, dev)
    cache = AC.ProgramCache(max_entries=1)
    cache.get(big, cfg, device="cuda")
    cache.get(small, cfg, device="cuda")          # evicts big
    a0, r0 = settled()
    grown = cache.get(big, cfg, device="cuda").memory_bytes
    _, r1 = settled()
    cache.get(small, cfg, device="cuda")          # evicts big again
    a2, r2 = settled()
    assert grown > 10 * 2 ** 20 and r1 - r0 >= grown // 2
    assert a2 <= a0 + 2 ** 20 and r2 <= r0 + 2 ** 21
    assert cache.stats()["evictions"] == 3


def test_full_covariance_entry_runs_eagerly_uncounted(dev):
    """Full covariance is never captured, by design: its entry runs the
    eager program and moves no fault counter."""
    from repro_torch.core import head as H
    from repro_torch.fl import round as FR
    from repro_torch.launch import aot_cache as AC
    cache = AC.ProgramCache()
    sig = FR.CohortSignature(M=2, C=2, K=1, d=8, cov_type="full")
    prog = cache.get(sig, H.HeadConfig(n_steps=5), device="cuda")
    assert not prog.aot and "full covariance" in prog.eager_reason
    assert cache.stats()["jit_fallbacks"] == 0
    assert cache.stats()["compiles"] == 0 and prog.memory_bytes == 0


def test_default_canonical_grid_at_d1280_stays_under_the_byte_bound(dev):
    """The default grid (M 4/16/64 × K 1/2/4) at hubert-xlarge's width with
    the default head: nine captures, none evicted or fallen back, their
    memory under the default ``max_bytes``, and the device's reserved
    memory grown by no more than the entries say they hold (plus the
    library workspaces of the cache's side stream).  Prints each entry's
    memory and the capture time (run with ``-s``)."""
    import gc

    from repro_torch.core import head as H
    from repro_torch.launch import aot_cache as AC
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    r0 = torch.cuda.memory_reserved()
    cache = AC.ProgramCache()
    st = cache.warmup(AC.canonical_grid(10, 1280), H.HeadConfig(),
                      device="cuda")
    print(json.dumps({"entry_memory_bytes": [e.memory_bytes
                                             for e in cache.entries()],
                      "total_bytes": cache.memory_bytes,
                      "capture_s": st["total_compile_us"] / 1e6}))
    assert st["compiles"] == 9 and st["entries"] == 9
    assert st["evictions"] == 0 and st["jit_fallbacks"] == 0
    assert all(e.memory_bytes > 0 for e in cache.entries())
    assert cache.memory_bytes <= cache.max_bytes
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    grown = torch.cuda.memory_reserved() - r0
    assert grown <= cache.memory_bytes + (256 << 20), (grown,
                                                       cache.memory_bytes)


def _to_cpu(tree):
    return {k: _to_cpu(v) if isinstance(v, dict) else v.cpu()
            for k, v in tree.items()}


@pytest.mark.parametrize("name,over", [("granite-3-2b", {}),
                                       ("rwkv6-3b", {}),
                                       ("zamba2-7b", {"n_layers": 5}),
                                       ("nemotron-4-340b", {}),
                                       ("granite-34b", {})])
def test_prefill_and_decode_on_card_match_the_cpu_path(dev, name, over):
    """A prefill of ragged length and two decode steps, four rows at their
    own positions, through the kernels on the card against the plain CPU
    path on the same weights (bf16); the decode steps launch
    ``attention_cached`` (dense, hybrid) and no plain version."""
    cfg = get_config(name).reduced(**over)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    params = M.init_params(cfg, g, device=dev)
    tokens = torch.randint(1, cfg.vocab_size, (4, 40), device=dev)
    (card, counts), (plain, _) = prefill_and_decode(cfg, params, tokens)
    torch.testing.assert_close(card, plain, rtol=5e-2, atol=5e-2)
    if cfg.family != "ssm":
        assert counts["attention_cached"] >= 2
    assert not any(v for k, v in counts.items()
                   if k.startswith("plain_on_cuda"))


PREFILL_LENGTHS = np.asarray([37, 21, 30, 9])


def prefill_and_decode(cfg, params, tokens, where=("card", "cpu")):
    """Each row's prefill of its ``PREFILL_LENGTHS`` tokens into its slot
    of one cache, then two decode steps of the four rows at their own
    positions, on the card and on the CPU (the same weights): {where:
    (the logits (3, 4, V) f32 on the CPU, the launch counts of the
    decode steps)}."""
    from repro_torch import serve as S
    cpu = _to_cpu(params)
    out = {}
    for w in where:
        p, tok = (params, tokens) if w == "card" else (cpu, tokens.cpu())
        cache = M.init_cache(cfg, 4, 64,
                             device="cuda" if w == "card" else "cpu")
        decode = S.make_decode_step(cfg)
        rows = []
        for b, L in enumerate(PREFILL_LENGTHS):  # each row's prefill
            view = {k: ({kk: vv[:, b:b + 1] for kk, vv in v.items()}
                        if isinstance(v, dict) else v[:, b:b + 1])
                    for k, v in cache.items()}
            last, _ = S.make_prefill_step(cfg, 64)(
                p, {"tokens": tok[b:b + 1, :L]}, cache=view)
            rows.append(last)
        steps = [torch.cat(rows)]
        nxt = tok[np.arange(4), PREFILL_LENGTHS][:, None]
        ops.reset_launch_counts()
        for i in range(2):
            lg, _ = decode(p, cache, nxt, PREFILL_LENGTHS + i)
            steps.append(lg)
        counts = ops.launch_counts()
        out[w] = (torch.stack(steps).float().cpu(), counts)
    return [out[w] for w in where]


def test_batched_server_on_card_equals_sequential(dev):
    """Granite-3-2b cut down, f32: the server's streams on the card equal
    each prompt's own greedy generation on the card, token for token."""
    import dataclasses as dc

    from repro_torch import serve as S
    from repro_torch.serve.server import BatchedServer, Request, ServerConfig
    cfg = dc.replace(get_config("granite-3-2b").reduced(), dtype="float32")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    params = M.init_params(cfg, g, device=dev)
    prompts = [torch.randint(1, cfg.vocab_size, (L,), generator=g,
                             device=dev) for L in (5, 19, 11, 3, 8)]
    srv = BatchedServer(cfg, params, ServerConfig(n_slots=3, max_seq=64))
    out = srv.run([Request(rid=i, prompt=p, max_new=6)
                   for i, p in enumerate(prompts)])
    for i, p in enumerate(prompts):
        want = S.greedy_generate(cfg, params, p[None], 6, 64)[0].tolist()
        assert out[i] == want


@pytest.mark.parametrize("tag", sorted(checks.MOE_CASES))
def test_moe_layer_on_card_matches_the_cpu(dev, tag):
    """One MoE layer at full width in f32 (``kernels.checks.MOE_CASES``):
    the card picks the CPU's routes, in the same order, and drops the
    same assignments; its output is within 1e-5 × max |y| (the two sum
    the f32 products in another order)."""
    name, T = checks.MOE_CASES[tag]
    cfg = dataclasses.replace(get_config(name), dtype="float32")
    g = torch.Generator()
    g.manual_seed(0)
    x, w = checks.moe_inputs(g, cfg, T)
    y, routes, drops = checks.moe_run(cfg, x, w)
    yc, routes_c, drops_c = checks.moe_run(
        cfg, x.to(dev), {k: v.to(dev) for k, v in w.items()})
    assert torch.equal(routes_c.cpu(), routes) and drops_c == drops
    assert drops > 0                 # capacity 1.25 drops at this size
    err = float((yc.cpu() - y).abs().max())
    assert err <= 1e-5 * float(y.abs().max()), err



def test_run_sharded_on_one_nccl_rank_is_the_host_star_round(dev):
    """``FedSession.run_sharded`` on a 1-rank NCCL group: the wire
    all-gather moves exactly Eqs. 9-11, the E-step runs as kernels, and
    the round is the host path's on the same draws (each client's fit
    from a generator seeded ``transfer_seed + i``, the server from
    ``round_generator(seed, 0)``)."""
    import torch.distributed as dist

    from repro_torch.core import distributed as DF
    from repro_torch.core import gmm as G
    from repro_torch.core import head as H
    from repro_torch.fl import api as A
    from repro_torch.launch import mesh as LM
    started = LM.ensure_process_group(dev)
    try:
        C, K, d, I, N = 5, 3, 64, 4, 300
        g = torch.Generator(device=dev).manual_seed(0)
        labels = torch.randint(0, C, (I, N), generator=g, device=dev)
        feats = (torch.randn(I, N, d, generator=g, device=dev)
                 + 3.0 * torch.nn.functional.one_hot(labels, d).float())
        sess = A.FedSession(
            n_classes=C, summarizer=A.GMMSummarizer(G.GMMConfig(K, "diag")),
            head=H.HeadConfig(n_steps=100), shards=1, transfer_seed=2)
        ops.reset_launch_counts()
        with DF.record_collectives() as tally:
            res = sess.run_sharded(feats, labels, seed=5)
        counts = ops.launch_counts()
        assert counts["estep_fused"] > 0
        assert not any(v for k, v in counts.items()
                       if k.startswith("plain_on_cuda"))
        want = DF.expected_wire_bytes("diag", d, K, C, I)
        assert tally["by_tag"]["wire"] == res.info["mesh_wire_bytes"] == want
        assert res.info["comm_bytes"] == sum(len(m.payload)
                                             for m in res.messages)
        msgs = []
        for i in range(I):
            gi = torch.Generator(device=dev).manual_seed(2 + i)
            msgs.append(sess.encode(*sess.client_summary(
                feats[i], labels[i], i, generator=gi, device=dev), i))
        host = dataclasses.replace(sess, shards=None).server_aggregate(
            msgs, generator=A.round_generator(5, 0, dev), device=dev)
        for m_mesh, m_host in zip(res.messages, msgs):
            assert m_mesh.header.counts == m_host.header.counts
            for f in G.WIRE_FIELDS:
                torch.testing.assert_close(m_mesh.params[f], m_host.params[f],
                                           rtol=2e-3, atol=2e-3)
        for p in ("w", "b"):
            torch.testing.assert_close(res.model[p], host.model[p],
                                       rtol=1e-2, atol=1e-2)
    finally:
        if started:
            dist.destroy_process_group()


def test_run_sharded_over_several_nccl_ranks_is_the_one_rank_head(
        dev, tmp_path):
    """``FedSession.run_sharded`` over min(cards, 4) NCCL ranks, one card a
    rank (spawned, ``tests/_torch_mesh_ranks.py``), against the 1-rank
    round in this process: every rank's head and decoded wire bit for bit
    the 1-rank round's (its docstring: results do not depend on the rank
    count)."""
    import torch.distributed as dist
    import torch.multiprocessing as mp

    import _torch_mesh_ranks as ranks
    from repro_torch.launch import mesh as LM
    world = min(torch.cuda.device_count(), 4)
    if world < 2:
        pytest.skip("needs at least 2 cards: NCCL takes one card a rank")
    C, K, d, I, N = 5, 3, 64, 8, 300
    g = torch.Generator().manual_seed(0)
    labels = torch.randint(0, C, (I, N), generator=g)
    inp = {"feats": torch.randn(I, N, d, generator=g)
           + 3.0 * torch.nn.functional.one_hot(labels, d).float(),
           "labels": labels, "C": C, "K": K}
    inputs = str(tmp_path / "inputs.pt")
    torch.save(inp, inputs)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=ranks.run_nccl,
                         args=(r, world, str(tmp_path), inputs))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
    assert all(not p.is_alive() and p.exitcode == 0 for p in procs), \
        [(p.is_alive(), p.exitcode) for p in procs]
    started = LM.ensure_process_group(dev)
    try:
        one = ranks.sharded_round(inp, 1, dev)
    finally:
        if started:
            dist.destroy_process_group()
    for r in range(world):
        got = torch.load(tmp_path / f"nccl_rank{r}.pt")
        for a, b in zip(got["wire"], one["wire"]):
            for f in a:
                assert torch.equal(a[f], b[f]), (r, f)
        for p in ("w", "b"):
            assert torch.equal(got["head"][p], one["head"][p]), (r, p)


def test_dryrun_pair_on_card(dev):
    """granite-3-2b's decode_32k at full width, 2 layers: 8 rows over a
    32 768-slot cache, all filled, through ``attention_cached``; the
    warm-up's recorded call, replayed on fresh inputs in its layouts,
    agrees with the plain version over every key."""
    from repro_torch.launch import dryrun as DR
    ops.reset_launch_counts()
    calls = []
    row = DR.run_pair("granite-3-2b", "decode_32k", verbose=False,
                      calls=calls)
    counts = ops.launch_counts()
    assert row["status"] == "ok" and row["rows"] == 8 and row["depth"] == 2
    assert row["step_ms"] > 0 and row["peak_bytes"] > 0
    assert row["flops"] > 0 and row["model_flops"] > 0
    assert row["masked_flops"] == 0 and row["peak_share"] == \
        row["plain_share"] > 0
    assert counts["attention_cached"] == 2 * 4       # a warm-up and 3 steps
    assert not any(v for k, v in counts.items()
                   if k.startswith("plain_on_cuda"))
    assert [c.name for c in calls] == ["attention_cached"] * 2
    q, k, v, q_pos, kv_pos = checks.replay_inputs(
        calls[0], torch.Generator(device=dev).manual_seed(0), dev)
    assert k.shape[2] == 32768
    assert bool(ref.positions_mask(q_pos, kv_pos).all())
    out = CA.attention_cached(q, k, v, q_pos, kv_pos)
    exp = ref.attention_positions_ref(q, k, v, q_pos, kv_pos)
    err = (out.float() - exp.float()).abs()
    assert bool((err <= 1e-2 + 1e-2 * exp.float().abs()).all())
