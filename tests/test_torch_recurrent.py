"""The port's recurrent kernels' plain versions against the JAX package.

``ref.wkv6_ref`` and ``ref.ssd_ref`` are held against the reference's XLA
chunked forms (``wkv6_chunked``, ``ssd_chunked``) and its Pallas kernels in
interpret mode, on the same numpy inputs, output and final state both; and
against the step-by-step recurrence that the CUDA kernels run
(``kernels.checks``).  The CUDA
kernels themselves are held against these plain versions on a card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances: 1e-4 for wkv6 and 2e-4 for ssd (``tests/test_wkv6_kernel.py``,
``tests/test_ssd_kernel.py``).
"""
import numpy as np
import pytest
import torch

from repro.kernels.ssd import ssd as jssd
from repro.kernels.wkv6 import wkv6 as jwkv6
from repro.models.mamba2 import ssd_chunked
from repro.models.rwkv import wkv6_chunked
from repro_torch.kernels import checks, ops, ref
from repro_torch.kernels import ssd as SSD
from repro_torch.kernels import wkv6 as WKV

WKV_TOL = 1e-4
SSD_TOL = 2e-4


def _softplus(a):
    return np.log1p(np.exp(a))


def _wkv6_inputs(seed, B, H, T, Dh):
    rng = np.random.RandomState(seed)
    r, k, v = (rng.randn(B, H, T, Dh).astype(np.float32) for _ in range(3))
    lw = (-_softplus(rng.randn(B, H, T, Dh))).astype(np.float32)
    u = (0.5 * rng.randn(H, Dh)).astype(np.float32)
    s0 = rng.randn(B, H, Dh, Dh).astype(np.float32)
    return r, k, v, lw, u, s0


def _ssd_inputs(seed, Bt, H, T, N, P):
    rng = np.random.RandomState(seed)
    x = rng.randn(Bt, H, T, P).astype(np.float32)
    al = (-0.2 * _softplus(rng.randn(Bt, H, T))).astype(np.float32)
    B = rng.randn(Bt, T, N).astype(np.float32)
    C = rng.randn(Bt, T, N).astype(np.float32)
    s0 = rng.randn(Bt, H, N, P).astype(np.float32)
    return x, al, B, C, s0


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _close(got, exp, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=tol,
                               atol=tol)


class TestWkv6:
    # the shapes of tests/test_wkv6_kernel.py, then T % chunk != 0
    @pytest.mark.parametrize("B,H,T,Dh,chunk", checks.WKV6_SHAPES)
    def test_matches_reference(self, B, H, T, Dh, chunk):
        args = _wkv6_inputs(T + Dh, B, H, T, Dh)
        out, sf = ref.wkv6_ref(*_t(*args), chunk=chunk)
        exp, sf_exp = wkv6_chunked(*args, chunk=chunk)
        _close(out, exp, WKV_TOL)
        _close(sf, sf_exp, WKV_TOL)
        # the Pallas kernel needs chunk | T: the chunk rule's C = T
        pchunk = chunk if T % chunk == 0 else T
        exp, sf_exp = jwkv6(*args, chunk=pchunk, interpret=True)
        _close(out, exp, WKV_TOL)
        _close(sf, sf_exp, WKV_TOL)

    def test_chunked_equals_the_kernels_step_recurrence(self):
        args = _t(*_wkv6_inputs(5, 2, 2, 40, 16))
        out, sf = ref.wkv6_ref(*args, chunk=16)
        out_s, sf_s = checks.wkv6_steps(*args)
        torch.testing.assert_close(out, out_s, rtol=WKV_TOL, atol=WKV_TOL)
        torch.testing.assert_close(sf, sf_s, rtol=WKV_TOL, atol=WKV_TOL)

    def test_bf16_keeps_the_input_dtype(self):
        r, k, v, lw, u, s0 = _t(*_wkv6_inputs(2, 1, 2, 32, 16))
        out, sf = ref.wkv6_ref(r.bfloat16(), k.bfloat16(), v.bfloat16(), lw,
                               u, s0, chunk=16)
        assert out.dtype == torch.bfloat16 and sf.dtype == torch.float32
        rf, kf, vf = (a.bfloat16().float() for a in (r, k, v))
        exp, sf_exp = ref.wkv6_ref(rf, kf, vf, lw, u, s0, chunk=16)
        torch.testing.assert_close(sf, sf_exp)
        torch.testing.assert_close(out, exp.bfloat16())


class TestSsd:
    # the shapes of tests/test_ssd_kernel.py, then T % chunk != 0
    @pytest.mark.parametrize("Bt,H,T,N,P,chunk", checks.SSD_SHAPES)
    def test_matches_reference(self, Bt, H, T, N, P, chunk):
        args = _ssd_inputs(T + N, Bt, H, T, N, P)
        y, sf = ref.ssd_ref(*_t(*args), chunk=chunk)
        exp, sf_exp = ssd_chunked(*args, chunk=chunk)
        _close(y, exp, SSD_TOL)
        _close(sf, sf_exp, SSD_TOL)
        pchunk = chunk if T % chunk == 0 else T
        exp, sf_exp = jssd(*args, chunk=pchunk, interpret=True)
        _close(y, exp, SSD_TOL)
        _close(sf, sf_exp, SSD_TOL)

    def test_chunked_equals_the_kernels_step_recurrence(self):
        args = _t(*_ssd_inputs(6, 2, 3, 40, 8, 16))
        y, sf = ref.ssd_ref(*args, chunk=16)
        y_s, sf_s = checks.ssd_steps(*args)
        torch.testing.assert_close(y, y_s, rtol=SSD_TOL, atol=SSD_TOL)
        torch.testing.assert_close(sf, sf_s, rtol=SSD_TOL, atol=SSD_TOL)


class TestDispatch:
    def test_cpu_tensors_take_plain_versions(self):
        ops.reset_launch_counts()
        wargs = _t(*_wkv6_inputs(0, 1, 2, 16, 8))
        sargs = _t(*_ssd_inputs(0, 1, 2, 16, 4, 8))
        for got, exp in ((ops.wkv6(*wargs, chunk=8),
                          ref.wkv6_ref(*wargs, chunk=8)),
                         (ops.ssd(*sargs, chunk=8),
                          ref.ssd_ref(*sargs, chunk=8))):
            for a, b in zip(got, exp):
                torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert all(v == 0 for v in ops.launch_counts().values())

    def test_kernel_wrappers_refuse_cpu_tensors(self):
        """No quiet fallback: the kernel wrappers take CUDA tensors only."""
        with pytest.raises(ValueError, match="CUDA"):
            WKV.wkv6(*_t(*_wkv6_inputs(0, 1, 2, 16, 8)))
        with pytest.raises(ValueError, match="CUDA"):
            SSD.ssd(*_t(*_ssd_inputs(0, 1, 2, 16, 4, 8)))
