"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA card and skips without one.  The file imports
neither JAX nor the JAX package, so it also runs where only PyTorch is
installed (``tests/conftest.py`` imports JAX, hence ``--noconftest``):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_cuda.py

Tolerances: E-step 3e-4; attention 2e-3 in f32 and 5e-2 in bf16 (the
reference's own kernel bounds, ``tests/test_kernels.py``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import FOUNDATION_STANDIN
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import gmm_estep as GE
from repro_torch.kernels import ops, ref
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rows_with_no_visible_key_are_zero(dev, dtype):
    q = torch.randn(1, 2, 8, 32, device=dev).to(dtype)
    k = torch.randn(1, 2, 4, 32, device=dev).to(dtype)
    out = FA.flash_attention(q, k, k, causal=True)
    assert float(out[:, :, :4].abs().max()) == 0.0


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
