"""The port's kernels module against the JAX package.

On the CPU the port's ``ops`` take the plain versions; these are held
against the JAX reference (its ``ref`` oracles and its Pallas kernels in
interpret mode) on the same numpy inputs.  The CUDA kernels themselves
are held against the plain versions by ``tests/test_torch_cuda.py`` (and
by ``chip_smoke.py``) on a card.

Tolerances: E-step 3e-4 (``tests/test_kernels.py``), attention 2e-3 in
f32 and 5e-2 in bf16 (the same file's flash-attention bounds).
"""
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.gmm_estep import estep as jestep
from repro.kernels.gmm_estep import estep_fused as jestep_fused
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import gmm_estep as GE
from repro_torch.kernels import ops

ESTEP_TOL = 3e-4
ATTN_TOL = 2e-3


def _estep_inputs(seed, Bx, B, N, K, d, spher=False):
    rng = np.random.RandomState(seed)
    x = rng.randn(Bx, N, d).astype(np.float32)
    mu = rng.randn(B, K, d).astype(np.float32)
    var_shape = (B, K) if spher else (B, K, d)
    var = (np.log1p(np.exp(rng.randn(*var_shape))) + 0.1).astype(np.float32)
    logits = rng.randn(B, K)
    pi = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)) \
        .astype(np.float32)
    return x, mu, var, pi


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


class TestEstepParity:
    @pytest.mark.parametrize("N,K,d", [(32, 1, 4), (257, 10, 64),
                                       (33, 7, 17), (1000, 5, 300)])
    def test_single_fit_matches_reference(self, N, K, d):
        x, mu, var, pi = _estep_inputs(N + K, 1, 1, N, K, d)
        x, mu, var, pi = x[0], mu[0], var[0], pi[0]
        got = ops.gmm_estep(*_t(x, mu, var, pi)).numpy()
        for exp in (jref.estep_ref(x, mu, var, pi),
                    jestep(x, mu, var, pi, interpret=True)):
            np.testing.assert_allclose(got, np.asarray(exp), rtol=ESTEP_TOL,
                                       atol=ESTEP_TOL)

    @pytest.mark.parametrize("Bx,B,N,K,d,spher", [
        (1, 3, 40, 4, 8, False),       # one client, C = 3 fits share x
        (2, 6, 33, 5, 12, True),       # cohort of 2, ragged N, spher var
        (3, 3, 20, 2, 6, False),       # one fit per block
    ])
    def test_fused_matches_reference(self, Bx, B, N, K, d, spher):
        x, mu, var, pi = _estep_inputs(B * N, Bx, B, N, K, d, spher)
        lp, lse = ops.gmm_estep_fused(*_t(x, mu, var, pi))
        for elp, else_ in (jref.estep_fused_ref(x, mu, var, pi),
                           jestep_fused(x, mu, var, pi, interpret=True)):
            np.testing.assert_allclose(lp.numpy(), np.asarray(elp),
                                       rtol=ESTEP_TOL, atol=ESTEP_TOL)
            np.testing.assert_allclose(lse.numpy(), np.asarray(else_),
                                       rtol=ESTEP_TOL, atol=ESTEP_TOL)

    def test_fused_unbatched_shapes(self):
        x, mu, var, pi = _estep_inputs(5, 1, 1, 21, 3, 5)
        lp, lse = ops.gmm_estep_fused(*_t(x[0], mu[0], var[0], pi[0]))
        assert lp.shape == (21, 3) and lse.shape == (21,)

    def test_fused_rejects_unshared_batch(self):
        x, mu, var, pi = _estep_inputs(1, 2, 3, 10, 2, 4)
        with pytest.raises(ValueError, match="multiple"):
            ops.gmm_estep_fused(*_t(x, mu, var, pi))


ATTN_CASES = [
    # B, H, Hkv, Sq, Sk, D, causal, window, prefix
    (1, 4, 4, 16, 16, 16, True, 0, 0),
    (2, 4, 2, 24, 24, 16, True, 0, 0),       # GQA
    (1, 2, 2, 20, 20, 16, True, 6, 0),       # sliding window
    (1, 4, 1, 8, 24, 16, True, 0, 0),        # MQA, queries at the tail
    (1, 2, 2, 24, 24, 80, False, 0, 0),      # bidirectional, D = 80
    (1, 4, 4, 24, 24, 16, True, 0, 5),       # bidirectional prefix
    (1, 2, 2, 24, 24, 16, True, 5, 3),       # window + prefix
    (1, 2, 2, 24, 24, 112, True, 0, 0),      # causal, D = 112 (zamba2-7b)
]


class TestAttentionParity:
    @pytest.mark.parametrize("B,H,Hkv,Sq,Sk,D,causal,window,prefix",
                             ATTN_CASES)
    def test_matches_reference(self, B, H, Hkv, Sq, Sk, D, causal, window,
                               prefix):
        rng = np.random.RandomState(Sq * 7 + D)
        q = rng.randn(B, H, Sq, D).astype(np.float32)
        k = rng.randn(B, Hkv, Sk, D).astype(np.float32)
        v = rng.randn(B, Hkv, Sk, D).astype(np.float32)
        kw = dict(causal=causal, window=window, prefix=prefix)
        got = ops.attention(*_t(q, k, v), **kw).numpy()
        for exp in (jref.attention_ref(q, k, v, **kw),
                    jflash(q, k, v, interpret=True, **kw)):
            np.testing.assert_allclose(got, np.asarray(exp), rtol=ATTN_TOL,
                                       atol=ATTN_TOL)

    def test_bf16_matches_reference(self):
        import jax.numpy as jnp
        rng = np.random.RandomState(3)
        qkv = [rng.randn(1, 2, 16, 32).astype(np.float32) for _ in range(3)]
        got = ops.attention(*[t.bfloat16() for t in _t(*qkv)],
                            causal=False)
        assert got.dtype == torch.bfloat16
        exp = jref.attention_ref(*[jnp.asarray(a, jnp.bfloat16)
                                   for a in qkv], causal=False)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(exp, np.float32),
                                   rtol=5e-2, atol=5e-2)


class TestDispatch:
    def test_cpu_tensors_take_plain_versions(self):
        ops.reset_launch_counts()
        x, mu, var, pi = _t(*_estep_inputs(0, 1, 2, 10, 3, 4))
        ops.gmm_estep_fused(x, mu, var, pi)
        ops.gmm_estep(x[0], mu[0], var[0], pi[0])
        q = torch.randn(1, 2, 8, 16)
        ops.attention(q, q, q)
        assert all(v == 0 for v in ops.launch_counts().values())

    def test_kernel_wrappers_refuse_cpu_tensors(self):
        """No quiet fallback: the kernel wrappers take CUDA tensors only."""
        x, mu, var, pi = _t(*_estep_inputs(0, 1, 2, 10, 3, 4))
        with pytest.raises(ValueError, match="CUDA"):
            GE.estep_fused(x, mu, var, pi)
        with pytest.raises(ValueError, match="CUDA"):
            GE.estep(x[0], mu[0], var[0], pi[0])
        q = torch.randn(1, 2, 8, 16)
        with pytest.raises(ValueError, match="CUDA"):
            FA.flash_attention(q, q, q)
