"""The SSD chunk length changes only rounding: the ground for the bf16
tensor-core kernel of ``csrc/ssd.cu`` choosing its own chunk (64) whatever
the model's ``chunk_size`` (256 for zamba2-7b).

At the path's state and head sizes (N = P = 64) and T = 512, in f32,
``ref.ssd_ref`` at chunk 64 agrees with itself at chunk 256 and with the
JAX package's ``models.mamba2.ssd_chunked`` at chunk 256, output and final
state, within 2e-4 (``tests/test_ssd_kernel.py``'s tolerance).  And an
emulation of the kernel's bf16 arithmetic shows why M, the state and the
decayed x enter its products as hi + lo bf16 halves.
"""
import numpy as np
import pytest
import torch

from repro.models.mamba2 import ssd_chunked
from repro_torch.kernels import checks, ref

SSD_TOL = 2e-4
N = P = 64
T = 512


def _inputs(seed, Bt, H, s0_scale, model_like):
    """Reference-test inputs, or the Mamba2 block's scale (x of unit size,
    a_log = Δ·A with Δ in [1e-3, 0.1] and A = −1)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(Bt, H, T, P)
    if model_like:
        al = -(1e-3 + 0.099 * rng.rand(Bt, H, T))
    else:
        al = -0.2 * np.log1p(np.exp(rng.randn(Bt, H, T)))
    B, C = rng.randn(Bt, T, N), rng.randn(Bt, T, N)
    s0 = s0_scale * rng.randn(Bt, H, N, P)
    return [a.astype(np.float32) for a in (x, al, B, C, s0)]


CASES = [(1, 2, 0.0, True), (2, 1, 1.0, True), (1, 2, 1.0, False)]


@pytest.mark.parametrize("against", ["ref_chunk256", "jax_chunk256"])
@pytest.mark.parametrize("Bt,H,s0_scale,model_like", CASES)
def test_chunk64_matches_chunk256(Bt, H, s0_scale, model_like, against):
    args = _inputs(Bt + 3 * H, Bt, H, s0_scale, model_like)
    y, s = ref.ssd_ref(*(torch.from_numpy(a) for a in args), chunk=64)
    if against == "ref_chunk256":
        ey, es = ref.ssd_ref(*(torch.from_numpy(a) for a in args),
                             chunk=256)
        ey, es = ey.numpy(), es.numpy()
    else:
        ey, es = (np.asarray(a) for a in ssd_chunked(*args, chunk=256))
    assert y.shape == (Bt, H, T, P) and s.shape == (Bt, H, N, P)
    np.testing.assert_allclose(y.numpy(), ey, rtol=SSD_TOL, atol=SSD_TOL)
    np.testing.assert_allclose(s.numpy(), es, rtol=SSD_TOL, atol=SSD_TOL)


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _kernel_arithmetic(x, a_log, B, C, s0, round_m):
    """The bf16 tensor-core kernel's arithmetic (``csrc/ssd.cu``), chunk 64:
    the f32 operands M = G ⊙ decay, S and the decayed x enter its bf16
    products as hi + lo halves, or (``round_m="once"``) M as one bf16
    rounding; products accumulate in f32, y is rounded to bf16 once."""
    def split(t):
        hi = _bf16(t)
        return hi + _bf16(t - hi)
    L = 64
    S = s0.float()
    ys = []
    for c0 in range(0, x.shape[2], L):
        xc, al = x[:, :, c0:c0 + L].float(), a_log[:, :, c0:c0 + L].float()
        Bc, Cc = B[:, c0:c0 + L].float(), C[:, c0:c0 + L].float()
        cw = torch.cumsum(al, -1)
        tri = torch.tril(torch.ones(L, L, dtype=torch.bool))
        M = torch.where(tri, torch.exp(cw[..., :, None] - cw[..., None, :]),
                        torch.zeros(())) \
            * torch.einsum("btn,bsn->bts", Cc, Bc)[:, None]
        M = _bf16(M) if round_m == "once" else split(M)
        y = torch.einsum("bhts,bhsp->bhtp", M, xc) + torch.exp(cw)[..., None] \
            * torch.einsum("btn,bhnp->bhtp", Cc, split(S))
        xd = xc * torch.exp(cw[..., -1:] - cw)[..., None]
        S = torch.exp(cw[..., -1:])[..., None] * S \
            + torch.einsum("bsn,bhsp->bhnp", Bc, split(xd))
        ys.append(y)
    return torch.cat(ys, 2).to(x.dtype), S


@pytest.mark.parametrize("round_m,within", [("split", True), ("once", False)])
def test_bf16_kernel_needs_hi_lo_operands(round_m, within):
    """At the path's N = P = 64, T = 512 with the Mamba2 block's scale, the
    kernel's arithmetic holds the bf16 tolerance of the card checks
    (1e-2·(1 + |exp|), ``chip_smoke.py``) against ``ref.ssd_ref`` only with
    the hi + lo operands: one bf16 rounding of M puts near-zero outputs
    about 19× past it."""
    g = torch.Generator()
    g.manual_seed(1)
    args = checks.ssd_inputs(g, "cpu", 2, 8, 512, 64, 64, torch.bfloat16,
                             0.0, model_like=True)
    exp = ref.ssd_ref(*args, chunk=256)
    got = _kernel_arithmetic(*args, round_m=round_m)
    ratio = max(float(((a.float() - b.float()).abs()
                       / (1e-2 + 1e-2 * b.float().abs())).max())
                for a, b in zip(got, exp))
    assert (ratio <= 1.0) == within, ratio
    if not within:
        assert ratio > 10.0, ratio
