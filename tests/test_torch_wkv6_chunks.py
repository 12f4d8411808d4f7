"""The bf16 wkv6 kernel's arithmetic, emulated on the CPU.

``csrc/wkv6.cu`` runs the chunked WKV6 form on the tensor cores at its own
chunk of 64 steps, four row tiles of 16 a chunk: the decay of the
intra-chunk term is split around a reference step (the start of a warp's
row tile, or step 8 of its diagonal tile) so that both factors are ≤ 1,
the two 8 × 8 diagonal quadrants of each row tile take the exact pairwise
exponent on the CUDA cores, and every f32 operand of a bf16 product (the
decayed r and k, A, the state and the decayed k of the update) enters as
hi + lo bf16 halves.  ``kernel_arithmetic`` repeats that arithmetic in torch, rounding
where the kernel rounds.

At the path's Dh = 64 and T = 512 (and a ragged T = 200), with the RWKV
block's inputs, lw ≡ −8 (the model's clamp), lw ≡ 0 and a nonzero s0, it
holds the card checks' bf16 tolerance (1e-2·(1 + |exp|), ``chip_smoke.py``
``REC_TOL_BF16``) against the JAX package's ``models.rwkv.wkv6_chunked``
and the float64 step recurrence, output and final state; one bf16
rounding of any split operand instead puts outputs past it.  In f32, with
no rounding, the kernel's split of the chunk changes only rounding against
the reference's chunk of 64 (1e-4, ``tests/test_wkv6_kernel.py``).
"""
import numpy as np
import pytest
import torch

from repro.models.rwkv import wkv6_chunked
from repro_torch.kernels import checks, ref

REC_TOL_BF16 = 1e-2
WKV_TOL = 1e-4
B, H, Dh = 2, 4, 64
L, TILE, HALF = 64, 16, 8          # the kernel's chunk, row tile, quadrant
LOG2E = 1.4426950408889634
SPLIT = ("q", "kt", "A", "rdec", "S", "kdec")


def _bf16(t):
    return t.to(torch.bfloat16).float()


def kernel_arithmetic(r, k, v, lw, u, s0, once=(), f32=False):
    """(out in r's dtype, final state f32) as ``csrc/wkv6.cu``'s bf16
    kernel computes them: the operands in ``SPLIT`` as hi + lo bf16 halves
    (a product of two split operands drops lo·lo, as the kernel does),
    those named in ``once`` as one bf16 rounding; ``f32`` rounds none."""
    def halves(name, t):
        hi = _bf16(t)
        lo = torch.zeros_like(t) if name in once else _bf16(t - hi)
        return hi, lo

    def prod(eq, na, a, nb, b):
        if f32:
            return torch.einsum(eq, a, b)
        ah, al = halves(na, a)
        bh, bl = halves(nb, b)
        return (torch.einsum(eq, ah, bh) + torch.einsum(eq, ah, bl)
                + torch.einsum(eq, al, bh))

    def times_v(eq, na, a, vv):
        if f32:
            return torch.einsum(eq, a, vv)
        ah, al = halves(na, a)
        return torch.einsum(eq, ah + al, vv)

    Bn, Hn, T, D = r.shape
    S = s0.float()
    uf = u.float()[None, :, None, :]
    strict = torch.tril(torch.ones(HALF, HALF, dtype=torch.bool), -1)
    diag = torch.arange(TILE)
    outs = []
    for c0 in range(0, T, L):
        n = min(L, T - c0)

        def chunk(a):                   # rows past T arrive as zeros
            a = a[:, :, c0:c0 + n].float()
            pad = a.new_zeros(Bn, Hn, L - n, D)
            return torch.cat([a, pad], 2)
        rc, kc, vc = chunk(r), chunk(k), chunk(v)
        cw = torch.cumsum(chunk(lw) * LOG2E, 2)        # log2 units
        cwp = torch.cat([torch.zeros_like(cw[:, :, :1]), cw[:, :, :-1]], 2)
        y = torch.zeros(Bn, Hn, L, D)
        for t0 in range(0, L, TILE):
            rows = slice(t0, t0 + TILE)
            ref0 = cwp[:, :, t0:t0 + 1]
            q = rc[:, :, rows] * torch.exp2(cwp[:, :, rows] - ref0)
            A = torch.zeros(Bn, Hn, TILE, t0 + TILE)
            if t0:                      # s-tiles before the row tile
                kt = kc[:, :, :t0] * torch.exp2(ref0 - cw[:, :, :t0])
                A[..., :t0] = prod("bhtd,bhsd->bhts", "q", q, "kt", kt)
            # the diagonal tile: t >= t0 + 8 > s at the reference step t0 + 8
            ref8 = cwp[:, :, t0 + HALF:t0 + HALF + 1]
            lo_t, lo_s = slice(t0 + HALF, t0 + TILE), slice(t0, t0 + HALF)
            q8 = rc[:, :, lo_t] * torch.exp2(cwp[:, :, lo_t] - ref8)
            k8 = kc[:, :, lo_s] * torch.exp2(ref8 - cw[:, :, lo_s])
            A[..., HALF:, t0:t0 + HALF] = prod("bhtd,bhsd->bhts", "q", q8,
                                               "kt", k8)
            # ... its two 8 x 8 diagonal quadrants with the exact exponent
            for o in (0, HALF):
                quad = slice(t0 + o, t0 + o + HALF)
                ex = torch.exp2(cwp[:, :, quad, None, :]
                                - cw[:, :, None, quad, :])
                ex = torch.where(strict[..., None], ex, torch.zeros(()))
                A[..., o:o + HALF, t0 + o:t0 + o + HALF] = torch.einsum(
                    "bhtd,bhsd,bhtsd->bhts", rc[:, :, quad], kc[:, :, quad],
                    ex)
            A[..., diag, t0 + diag] = (rc[:, :, rows] * kc[:, :, rows]
                                       * uf).sum(-1)   # the bonus
            rdec = q * torch.exp2(ref0)
            y[:, :, rows] = times_v("bhts,bhse->bhte", "A", A,
                                    vc[:, :, :t0 + TILE]) \
                + prod("bhtd,bhde->bhte", "rdec", rdec, "S", S)
        kdec = kc * torch.exp2(cw[:, :, L - 1:L] - cw)
        S = torch.exp2(cw[:, :, L - 1])[..., None] * S \
            + times_v("bhsd,bhse->bhde", "kdec", kdec, vc)
        outs.append(y[:, :, :n])
    return torch.cat(outs, 2).to(r.dtype), S


def _inputs(case, T, dtype=torch.bfloat16):
    """The RWKV block's inputs (``checks.wkv6_inputs``, model-like), with
    s0 = 0 (as the path passes it) or 1, or lw held at −8 or 0."""
    g = torch.Generator()
    g.manual_seed(T + len(case))
    s0_scale, fill = {"model": (0.0, None), "s0": (1.0, None),
                      "lw=-8": (1.0, -8.0), "lw=0": (1.0, 0.0)}[case]
    kw = {} if fill is None else {"lw_fill": fill}
    return checks.wkv6_inputs(g, "cpu", B, H, T, Dh, dtype, s0_scale,
                              model_like=True, **kw)


def _ratio(got, exp, tol):
    """max over out and state of |got − exp| / (tol·(1 + |exp|))."""
    return max(float(((a.double() - b.double()).abs()
                      / (tol + tol * b.double().abs())).max())
               for a, b in zip(got, exp))


def _jax(args, chunk):
    out, s = wkv6_chunked(*(a.float().contiguous().numpy() for a in args),
                          chunk=chunk)
    return torch.from_numpy(np.array(out)), torch.from_numpy(np.array(s))


def _steps(args):
    return checks.wkv6_steps(*(a.double() for a in args))


@pytest.mark.parametrize("against", ["jax_chunk64", "float64_steps"])
@pytest.mark.parametrize("T", [512, 200])
@pytest.mark.parametrize("case", ["model", "s0", "lw=-8", "lw=0"])
def test_bf16_kernel_arithmetic_holds_the_bar(case, T, against):
    args = _inputs(case, T)
    got = kernel_arithmetic(*args)
    assert got[0].dtype == torch.bfloat16 and got[0].shape == (B, H, T, Dh)
    assert got[1].dtype == torch.float32 and got[1].shape == (B, H, Dh, Dh)
    exp = _jax(args, 64) if against == "jax_chunk64" else _steps(args)
    assert _ratio(got, exp, REC_TOL_BF16) <= 1.0


@pytest.mark.parametrize("operand", SPLIT)
def test_one_bf16_rounding_of_a_split_operand_breaks_the_bar(operand):
    """Against the plain version the card holds the kernel to, at the
    path's shape and the RWKV block's inputs: the halves stay inside the
    bar, one rounding of any one of them does not."""
    args = _inputs("model", 512)
    exp = ref.wkv6_ref(*args, chunk=64)
    assert _ratio(kernel_arithmetic(*args), exp, REC_TOL_BF16) <= 1.0
    assert _ratio(kernel_arithmetic(*args, once=(operand,)), exp,
                  REC_TOL_BF16) > 1.5


@pytest.mark.parametrize("T,against", [(512, "jax_chunk64"),
                                       (512, "float64_steps"),
                                       (200, "float64_steps")])
@pytest.mark.parametrize("case", ["model", "lw=-8", "lw=0"])
def test_f32_kernel_split_changes_only_rounding(case, T, against):
    """No bf16 rounding: the kernel's chunk of 64 in row tiles of 16 and
    quadrants of 8 against the reference's chunk of 64 (at T = 200 the
    reference takes one chunk of 200, whose f32 sums round past 1e-4 on
    outputs near zero: there the float64 steps are the reference)."""
    args = _inputs(case, T, torch.float32)
    got = kernel_arithmetic(*args, f32=True)
    exp = _jax(args, 64) if against == "jax_chunk64" else _steps(args)
    assert _ratio(got, exp, WKV_TOL) <= 1.0
