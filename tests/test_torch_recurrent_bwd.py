"""The plain backward versions of the recurrent kernels against the JAX
package.

``ref.wkv6_bwd_ref`` and ``ref.ssd_bwd_ref`` (what ``csrc/wkv6_bwd.cu`` and
``csrc/ssd_bwd.cu`` compute) are held against ``jax.vjp`` of the
reference's XLA chunked forms ``wkv6_chunked`` / ``ssd_chunked`` (its
Pallas forwards have no VJP) and against autograd of the port's
``ref.wkv6_ref`` / ``ref.ssd_ref``, every output, on the same numpy
inputs with a nonzero initial state and final-state gradient, at T a
multiple of the chunk and not.  The prefix sums by which the kernels take
dlw and da_log (``ref.wkv6_dlw_prefix``, ``ref.ssd_da_prefix``) are held
against the direct formulas on their own, and lw at the model's clamp
(``LW_MIN = −8``) shows that no decay ratio overflows.  The CUDA kernels
are held against these plain versions on a card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances: ``WKV_TOL`` 1e-4 and ``SSD_TOL`` 2e-4
(``tests/test_torch_recurrent.py``), × each gradient's max: both sides
sum in f32 in their own orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.mamba2 import ssd_chunked
from repro.models.rwkv import LW_MIN, wkv6_chunked
from repro_torch.kernels import checks, ref
from repro_torch.kernels import ssd_bwd as SSDB
from repro_torch.kernels import wkv6_bwd as WKVB

WKV_TOL = 1e-4
SSD_TOL = 2e-4


def _softplus(a):
    return np.log1p(np.exp(a))


def _wkv6_case(seed, B, H, T, Dh, lw_low=None):
    """(r, k, v, lw, u, s0) and the cotangents (d_out, dS_T), numpy f32;
    lw uniform in [lw_low, lw_low + 1] when given."""
    rng = np.random.RandomState(seed)
    r, k, v = (rng.randn(B, H, T, Dh).astype(np.float32) for _ in range(3))
    if lw_low is None:
        lw = -_softplus(rng.randn(B, H, T, Dh))
    else:
        lw = lw_low + rng.rand(B, H, T, Dh)
    u = 0.5 * rng.randn(H, Dh)
    s0 = rng.randn(B, H, Dh, Dh)
    do = rng.randn(B, H, T, Dh)
    dS = rng.randn(B, H, Dh, Dh)
    return ([r, k, v, lw.astype(np.float32), u.astype(np.float32),
             s0.astype(np.float32)],
            [do.astype(np.float32), dS.astype(np.float32)])


def _ssd_case(seed, Bt, H, T, N, P):
    rng = np.random.RandomState(seed)
    x = rng.randn(Bt, H, T, P)
    al = -0.2 * _softplus(rng.randn(Bt, H, T))
    Bm, Cm = rng.randn(Bt, T, N), rng.randn(Bt, T, N)
    s0 = rng.randn(Bt, H, N, P)
    dy, dS = rng.randn(Bt, H, T, P), rng.randn(Bt, H, N, P)
    return ([a.astype(np.float32) for a in (x, al, Bm, Cm, s0)],
            [a.astype(np.float32) for a in (dy, dS)])


def _t(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _jax_vjp(fn, args, cot, chunk):
    _, pull = jax.vjp(lambda *a: fn(*a, chunk=chunk),
                      *(jnp.asarray(a) for a in args))
    return [np.asarray(g) for g in pull(tuple(jnp.asarray(c) for c in cot))]


def _autograd(fn, args, cot, chunk):
    leaves = [a.clone().requires_grad_() for a in _t(args)]
    out = fn(*leaves, chunk=chunk)
    torch.autograd.backward(out, _t(cot))
    return [t.grad for t in leaves]


def _close(name, got, exp, tol):
    exp = torch.as_tensor(np.array(exp)).float()
    got = got.float()
    assert got.shape == exp.shape, (name, got.shape, exp.shape)
    assert bool(torch.isfinite(got).all()), name
    err = float((got - exp).abs().max())
    assert err <= tol * float(exp.abs().max()), (name, err,
                                                 float(exp.abs().max()))


# (B, H, T, Dh, chunk): T a multiple of the chunk, then not (one chunk of
# T), at the head dims of the kernel
WKV6_BWD_SHAPES = [(2, 2, 32, 16, 8), (1, 3, 40, 8, 16), (1, 2, 24, 32, 8),
                   (1, 1, 20, 64, 16)]
# (Bt, H, T, N, P, chunk): likewise
SSD_BWD_SHAPES = [(2, 3, 32, 8, 16, 8), (1, 2, 40, 4, 8, 16),
                  (2, 2, 24, 16, 32, 8), (1, 2, 20, 64, 64, 16)]
WKV6_NAMES = ("dr", "dk", "dv", "dlw", "du", "dS0")
SSD_NAMES = ("dx", "da_log", "dB", "dC", "dS0")


@pytest.mark.parametrize("B,H,T,Dh,chunk", WKV6_BWD_SHAPES)
def test_wkv6_bwd_ref_matches_jax_vjp_and_autograd(B, H, T, Dh, chunk):
    args, cot = _wkv6_case(T + Dh, B, H, T, Dh)
    got = ref.wkv6_bwd_ref(*_t(args), *_t(cot))
    for exp in (_jax_vjp(wkv6_chunked, args, cot, chunk),
                _autograd(ref.wkv6_ref, args, cot, chunk)):
        for name, a, e in zip(WKV6_NAMES, got, exp):
            _close(name, a, e, WKV_TOL)


@pytest.mark.parametrize("Bt,H,T,N,P,chunk", SSD_BWD_SHAPES)
def test_ssd_bwd_ref_matches_jax_vjp_and_autograd(Bt, H, T, N, P, chunk):
    args, cot = _ssd_case(T + N, Bt, H, T, N, P)
    got = ref.ssd_bwd_ref(*_t(args), *_t(cot))
    for exp in (_jax_vjp(ssd_chunked, args, cot, chunk),
                _autograd(ref.ssd_ref, args, cot, chunk)):
        for name, a, e in zip(SSD_NAMES, got, exp):
            _close(name, a, e, SSD_TOL)


def test_wkv6_bwd_at_the_decay_clamp_does_not_overflow():
    """lw in [−8, −7]: the sweeps only ever multiply by e^{lw} ≤ 1, and
    match the float64 step recurrence's autograd.  The chunked forms'
    VJP does not: their masked pairwise exponents reach e^{+100} within a
    chunk of 16, and the mask's zero times that inf makes dlw NaN, in the
    reference as in autograd of the port's plain version (from a chunk of
    12 steps at this lw; rwkv6-3b's chunk is 64)."""
    assert LW_MIN == -8.0
    args, cot = _wkv6_case(7, 1, 2, 48, 16, lw_low=LW_MIN)
    got = ref.wkv6_bwd_ref(*_t(args), *_t(cot))
    leaves = [a.double().requires_grad_() for a in _t(args)]
    torch.autograd.backward(checks.wkv6_steps(*leaves),
                            [c.double() for c in _t(cot)])
    for name, a, t in zip(WKV6_NAMES, got, leaves):
        _close(name, a, t.grad.numpy(), WKV_TOL)
    for chunked in (_jax_vjp(wkv6_chunked, args, cot, 16),
                    _autograd(ref.wkv6_ref, args, cot, 16)):
        assert not np.isfinite(np.asarray(chunked[3])).all()


def _f64(arrays):
    return [a.double() for a in _t(arrays)]


@pytest.mark.parametrize("lw_low", [None, LW_MIN])
def test_wkv6_dlw_prefix_sum_is_the_direct_formula(lw_low):
    """dlw_j = ⟨s0, dS0⟩ + Σ_{s<j} k_s dk̃_s − Σ_{t≤j} r_t dr̃_t, per row of
    the state, equals e^{lw_j} rowsum(Ḡ_j ⊙ S_{j−1}) (float64)."""
    args, cot = _wkv6_case(3, 2, 2, 30, 16, lw_low=lw_low)
    r, k, v, lw, u, s0 = _f64(args)
    do, dS = _f64(cot)
    dr, dk, dv, dlw, du, ds0 = ref.wkv6_bwd_ref(r, k, v, lw, u, s0, do, dS)
    bonus = u[None, :, None] * (v * do).sum(-1, keepdim=True)
    prefix = ref.wkv6_dlw_prefix(r, k, s0, dr - bonus * k, dk - bonus * r,
                                 ds0)
    torch.testing.assert_close(prefix, dlw, rtol=1e-9,
                               atol=1e-9 * float(dlw.abs().max()))


def test_ssd_da_prefix_sum_is_the_direct_formula():
    """da_j = ⟨s0, dS0⟩ + Σ_{s<j} x_s·dx_s − Σ_{t<j} C_t·dC_t^{(h)} per
    (b, h) equals e^{a_j} ⟨Ḡ_j, S_{j−1}⟩ (float64); dC^{(h)} is each head's
    share, which sums to dC."""
    args, cot = _ssd_case(4, 2, 3, 30, 8, 16)
    x, al, Bm, Cm, s0 = _f64(args)
    dy, dS = _f64(cot)
    dx, da, dB, dC, ds0 = ref.ssd_bwd_ref(x, al, Bm, Cm, s0, dy, dS)
    S, heads = s0, []
    for t in range(x.shape[2]):
        S = torch.exp(al[:, :, t])[..., None, None] * S \
            + Bm[:, None, t, :, None] * x[:, :, t, None, :]
        heads.append(torch.einsum("bhnp,bhp->bhn", S, dy[:, :, t]))
    heads = torch.stack(heads, 2)
    torch.testing.assert_close(heads.sum(1), dC)
    prefix = ref.ssd_da_prefix(x, Cm, s0, dx, heads, ds0)
    torch.testing.assert_close(prefix, da, rtol=1e-9,
                               atol=1e-9 * float(da.abs().max()))


def test_bf16_inputs_give_gradients_in_their_dtype():
    """bf16 r, k, v, d_out (x, B, C, dy): the sweeps run in f32 on the
    rounded inputs; dr, dk, dv (dx, dB, dC) come back in bf16, the rest
    f32."""
    args, cot = _wkv6_case(1, 1, 2, 16, 8)
    r, k, v, lw, u, s0 = _t(args)
    do, dS = _t(cot)
    bf = [a.bfloat16() for a in (r, k, v, do)]
    got = ref.wkv6_bwd_ref(*bf[:3], lw, u, s0, bf[3], dS)
    exp = ref.wkv6_bwd_ref(*(a.float() for a in bf[:3]), lw, u, s0,
                           bf[3].float(), dS)
    for a, e, dt in zip(got, exp, (torch.bfloat16,) * 3
                        + (torch.float32,) * 3):
        assert a.dtype == dt
        torch.testing.assert_close(a, e.to(dt))
    args, cot = _ssd_case(1, 1, 2, 16, 4, 8)
    x, al, Bm, Cm, s0 = _t(args)
    dy, dS = _t(cot)
    bf = [a.bfloat16() for a in (x, Bm, Cm, dy)]
    got = ref.ssd_bwd_ref(bf[0], al, bf[1], bf[2], s0, bf[3], dS)
    exp = ref.ssd_bwd_ref(bf[0].float(), al, bf[1].float(), bf[2].float(),
                          s0, bf[3].float(), dS)
    for a, e, dt in zip(got, exp, (torch.bfloat16, torch.float32,
                                   torch.bfloat16, torch.bfloat16,
                                   torch.float32)):
        assert a.dtype == dt
        torch.testing.assert_close(a, e.to(dt))


def test_backward_wrappers_refuse_cpu_tensors():
    """No quiet fallback: the backward kernels' wrappers take CUDA tensors
    only (``ops`` sends CPU tensors to autograd of the plain versions)."""
    args, cot = _wkv6_case(0, 1, 2, 16, 8)
    with pytest.raises(ValueError, match="CUDA"):
        WKVB.wkv6_bwd(*_t(args), _t(cot)[0])
    args, cot = _ssd_case(0, 1, 2, 16, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        SSDB.ssd_bwd(*_t(args), _t(cot)[0])
