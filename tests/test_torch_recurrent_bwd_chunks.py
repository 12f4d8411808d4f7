"""The bf16 backward kernels' arithmetic, emulated on the CPU.

``csrc/wkv6_bwd.cu`` and ``csrc/ssd_bwd.cu`` take bf16 inputs through the
chunked form on the tensor cores, in chunks of L = 64 steps that run in
parallel: (1) each chunk's own contribution to the state and to the
state's gradient, (2) a scan over the chunks that gives the state at every
chunk start and its gradient at every chunk end, and the dlw (da) of each
chunk's first step, (3) every chunk's outputs from those boundary states,
with dlw (da) the prefix sum of the ``.cu`` headers re-anchored at each
chunk's first step.  ``wkv6_arithmetic`` and ``ssd_arithmetic`` repeat
that arithmetic in torch and round where the kernels round: an f32
operand of a bf16 product as one bf16 rounding, or (ssd's M and W) as
hi + lo bf16 halves, f32 accumulation; wkv6's adjacent pairs of steps
and the exact quadrants in f32.

At Dh = 64 (N = P = 64) and T = 200 (a ragged last chunk) with a nonzero
s0 and final-state gradient, at strong decay (lw ≡ −8, a_log ≡ −2) and at
the blocks' own, they hold every gradient within ``RECUR_BWD_TOL_BF16``
(1e-2 × its max) of the float64 plain version and of the JAX package's
``jax.vjp`` of the chunked forms at a chunk of 10, where that stays
finite.  The controls show which precision choices carry that:
wkv6's dlw from a prefix over all of T, or re-anchored at each chunk with
the adjacent pairs kept in it, and one bf16 rounding of ssd's M or W, each
go past the tolerance.  Every other operand holds it with one rounding,
so the kernels split none of them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.mamba2 import ssd_chunked
from repro.models.rwkv import wkv6_chunked
from repro_torch.kernels import checks, ref

TOL = checks.RECUR_BWD_TOL_BF16
L, TILE, HALF = 64, 16, 8          # the kernels' chunk, row tile, quadrant
LOG2E = 1.4426950408889634
# the operands that enter as hi + lo halves; every other f32 operand of a
# product is rounded to bf16 once
WKV6_SPLIT = ()
SSD_SPLIT = ("M", "W")
WKV6_NAMES = ("dr", "dk", "dv", "dlw", "du", "dS0")
SSD_NAMES = ("dx", "da_log", "dB", "dC", "dS0")


def _bf16(t):
    return t.to(torch.bfloat16).float()


class _Rounding:
    """Where the kernels round: the operands named in ``split`` as hi + lo
    halves, the others (and those in ``once``) as one bf16 rounding."""

    def __init__(self, split, once=()):
        self.split, self.once = split, once

    def halves(self, name, t):
        hi = _bf16(t)
        return hi, (_bf16(t - hi) if name in self.split
                    and name not in self.once else torch.zeros_like(t))

    def mm(self, eq, na, a, nb, b):
        """A bf16 product with f32 accumulation; ``na`` / ``nb`` name a
        split operand, None a bf16 one."""
        if na is None or nb is None:
            if na is not None:
                a = sum(self.halves(na, a))
            if nb is not None:
                b = sum(self.halves(nb, b))
            return torch.einsum(eq, a, b)
        ah, al = self.halves(na, a)
        bh, bl = self.halves(nb, b)
        return (torch.einsum(eq, ah, bh) + torch.einsum(eq, ah, bl)
                + torch.einsum(eq, al, bh))


def _chunks(t, nc):
    """(B, H, T, ...) as (B, H, nc, L, ...) f32, rows past T zero."""
    T = t.shape[2]
    pad = t.new_zeros(*t.shape[:2], nc * L - T, *t.shape[3:])
    return torch.cat([t.float(), pad.float()], 2).reshape(
        *t.shape[:2], nc, L, *t.shape[3:])


def _excl_cumsum(z, dim):
    return torch.cumsum(z, dim) - z


def wkv6_arithmetic(r, k, v, lw, u, s0, do, dS_T, once=(), prefix="chunk"):
    """(dr, dk, dv, dlw, du, dS0) as ``csrc/wkv6_bwd.cu``'s bf16 route
    computes them.  ``prefix``: "chunk" (the kernel) starts dlw at each
    chunk's first step from phase 2 and keeps the adjacent pairs out of
    the prefix; "anchor" starts it from ⟨G_{c0−1}, S_{c0−1}⟩ with every
    term in the prefix; "whole" runs ``ref.wkv6_dlw_prefix`` over all of
    T."""
    R = _Rounding(WKV6_SPLIT, once)
    B, H, T, D = r.shape
    nc = -(-T // L)
    rc, kc, vc, dc = (_chunks(a, nc) for a in (r, k, v, do))
    lw2 = _chunks(lw, nc) * LOG2E
    cw = torch.cumsum(lw2, 3)                          # inclusive, log2
    cwp = torch.cat([torch.zeros_like(cw[..., :1, :]), cw[..., :-1, :]], 3)
    cwl = cw[..., L - 1, :]                            # (B, H, nc, D)
    uf = u.float()[None, :, None, None, :]

    # phase 1: each chunk's own contributions, all chunks at once
    kdec = kc * torch.exp2(cwl[..., None, :] - cw)
    dS = R.mm("bhcjd,bhcje->bhcde", "kdec", kdec, None, vc)
    rdec = rc * torch.exp2(cwp)
    dG = R.mm("bhcid,bhcie->bhcde", "rdec", rdec, None, dc)

    # phase 2: the scan over chunks (f32), and dlw at each chunk's first
    # step: <G_{c0-1} - r_{c0} do_{c0}^T, S_{c0-1}> per row
    S = s0.float()
    starts = []
    for c in range(nc):
        starts.append(S)
        S = torch.exp2(cwl[:, :, c])[..., None] * S + dS[:, :, c]
    G = torch.zeros_like(S) if dS_T is None else dS_T.float()
    ends, first = [None] * nc, [None] * nc
    for c in range(nc - 1, -1, -1):
        ends[c] = G
        G = torch.exp2(cwl[:, :, c])[..., None] * G + dG[:, :, c]
        own = rc[:, :, c, 0, :, None] * dc[:, :, c, 0, None, :]
        first[c] = ((G - own) * starts[c]).sum(-1)
        if prefix == "anchor":
            first[c] = (G * starts[c]).sum(-1)
    dS0 = G
    Sst, Gend = torch.stack(starts, 2), torch.stack(ends, 2)
    first = torch.stack(first, 2)                      # (B, H, nc, D)

    # phase 3: the outputs of every chunk
    Bm = torch.einsum("bhcie,bhcje->bhcij", dc, vc)    # do_i . v_j, f32
    vdo = torch.diagonal(Bm, 0, -2, -1)
    # the adjacent pairs (j = i - 1) leave the products: they are added
    # exactly, and the prefix of dlw cancels them exactly
    adj = torch.diagonal(Bm, -1, -2, -1)               # (.., L - 1)
    Bx = Bm - torch.diag_embed(adj, -1)
    strict = torch.tril(torch.ones(HALF, HALF, dtype=torch.bool), -1)
    drt, dkt = torch.zeros_like(rc), torch.zeros_like(rc)
    AT = torch.zeros(*rc.shape[:3], L, L)
    dn = dict(dtype=torch.float32)
    for t0 in range(0, L, TILE):
        rows = slice(t0, t0 + TILE)
        lo, hi = slice(t0, t0 + HALF), slice(t0 + HALF, t0 + TILE)
        ref8 = cw[..., t0 + HALF - 1:t0 + HALF, :]     # = cwp[t0 + 8]
        # dr~ (rows i): s-tiles before, at the reference cwp[t0]
        if t0:
            r0 = cwp[..., t0:t0 + 1, :]
            kr = kc[..., :t0, :] * torch.exp2(r0 - cw[..., :t0, :])
            drt[..., rows, :] = torch.exp2(cwp[..., rows, :] - r0) * R.mm(
                "bhcij,bhcjd->bhcid", "Bm", Bx[..., rows, :t0], "kr", kr)
        k8 = kc[..., lo, :] * torch.exp2(ref8 - cw[..., lo, :])
        drt[..., hi, :] += torch.exp2(cwp[..., hi, :] - ref8) * R.mm(
            "bhcij,bhcjd->bhcid", "Bm", Bx[..., hi, lo], "kr", k8)
        # dk~ (rows j): s-tiles after, at the reference cw[t0 + 15]
        if t0 + TILE < L:
            r15 = cw[..., t0 + TILE - 1:t0 + TILE, :]
            after = slice(t0 + TILE, L)
            rk = rc[..., after, :] * torch.exp2(cwp[..., after, :] - r15)
            dkt[..., rows, :] = torch.exp2(r15 - cw[..., rows, :]) * R.mm(
                "bhcij,bhcid->bhcjd", "Bm", Bx[..., after, rows], "rk", rk)
            kt = kc[..., rows, :] * torch.exp2(r15 - cw[..., rows, :])
            AT[..., rows, after] = R.mm("bhcjd,bhcid->bhcji", "kt", kt,
                                        "rt", rk)
        r8 = rc[..., hi, :] * torch.exp2(cwp[..., hi, :] - ref8)
        dkt[..., lo, :] += torch.exp2(ref8 - cw[..., lo, :]) * R.mm(
            "bhcij,bhcid->bhcjd", "Bm", Bx[..., hi, lo], "rk", r8)
        AT[..., lo, hi] = R.mm("bhcjd,bhcid->bhcji", "kt", k8, "rt", r8)
        # the two 8 x 8 diagonal quadrants, exact pairwise exponents (f32)
        for o in (lo, hi):
            ex = torch.exp2(cwp[..., o, None, :] - cw[..., None, o, :])
            ex = torch.where(strict[..., None], ex, torch.zeros((), **dn))
            drt[..., o, :] += torch.einsum("bhcij,bhcjd,bhcijd->bhcid",
                                           Bx[..., o, o], kc[..., o, :], ex)
            dkt[..., o, :] += torch.einsum("bhcij,bhcid,bhcijd->bhcjd",
                                           Bx[..., o, o], rc[..., o, :], ex)
            AT[..., o, o] = torch.einsum("bhcid,bhcjd,bhcijd->bhcji",
                                         rc[..., o, :], kc[..., o, :], ex)
    idx = torch.arange(L)
    AT[..., idx, idx] = (rc * kc * uf).sum(-1)         # the bonus
    # the boundary states' terms
    drt += torch.exp2(cwp) * R.mm("bhcie,bhcde->bhcid", None, dc, "S", Sst)
    dkt += torch.exp2(cwl[..., None, :] - cw) * R.mm(
        "bhcje,bhcde->bhcjd", None, vc, "G", Gend)
    dv = R.mm("bhcji,bhcie->bhcje", "A", AT, None, dc) \
        + R.mm("bhcjd,bhcde->bhcje", "kdec", kdec, "G", Gend)
    adj_r = torch.zeros_like(rc)
    adj_r[..., 1:, :] = adj[..., None] * kc[..., :-1, :]
    adj_k = torch.zeros_like(rc)
    adj_k[..., :-1, :] = adj[..., None] * rc[..., 1:, :]
    bonus = uf * vdo[..., None]
    dr = drt + adj_r + bonus * kc
    dk = dkt + adj_k + bonus * rc
    du = (rc * kc * vdo[..., None]).sum((0, 2, 3))

    zr, zk = rc * drt, kc * dkt
    if prefix == "chunk":
        zr[..., 0, :] = 0.0     # the first step's term is in ``first``
        dlw = first[..., None, :] + _excl_cumsum(zk - zr, 3) - zr
    elif prefix == "anchor":    # <G, S> at each chunk start, every term
        zr, zk = zr + rc * adj_r, zk + kc * adj_k
        dlw = first[..., None, :] + _excl_cumsum(zk - zr, 3) - zr
    else:                       # all of T: ref.wkv6_dlw_prefix
        zr, zk = zr + rc * adj_r, zk + kc * adj_k
        flat = lambda t: t.reshape(B, H, nc * L, D)   # noqa: E731
        c0 = (s0.float() * dS0).sum(-1)[:, :, None]
        dlw = c0 + _excl_cumsum(flat(zk) - flat(zr), 2) - flat(zr)
    cut = lambda t: t.reshape(B, H, nc * L, D)[:, :, :T]   # noqa: E731
    return (cut(dr).to(r.dtype), cut(dk).to(k.dtype), cut(dv).to(v.dtype),
            cut(dlw), du, dS0)


def ssd_arithmetic(x, a_log, Bm, Cm, s0, dy, dS_T, once=(), prefix="chunk"):
    """(dx, da_log, dB, dC, dS0) as ``csrc/ssd_bwd.cu``'s bf16 route
    computes them; ``prefix`` as for ``wkv6_arithmetic``."""
    R = _Rounding(SSD_SPLIT, once)
    Bt, H, T, P = x.shape
    nc = -(-T // L)
    xc, dyc = _chunks(x, nc), _chunks(dy, nc)          # (Bt, H, nc, L, P)
    Bc = _chunks(Bm[:, None], nc)[:, 0]                # (Bt, nc, L, N)
    Cc = _chunks(Cm[:, None], nc)[:, 0]
    cw = torch.cumsum(_chunks(a_log[..., None], nc)[..., 0], 3)
    cwl = cw[..., L - 1]                               # (Bt, H, nc)
    tri = torch.tril(torch.ones(L, L, dtype=torch.bool))
    # decay[i, j] = e^{cw_i - cw_j}, j <= i, the exponent masked first
    ex = torch.exp(torch.where(tri, cw[..., :, None] - cw[..., None, :],
                               torch.full((), -float("inf"))))
    tail = torch.exp(cwl[..., None] - cw)[..., None]   # e^{cw_last - cw_j}

    # phase 1
    bdec = Bc[:, None] * tail
    dS = R.mm("bhcjn,bhcjp->bhcnp", "bdec", bdec, None, xc)
    cdec = Cc[:, None] * torch.exp(cw)[..., None]
    dG = R.mm("bhcin,bhcip->bhcnp", "cdec", cdec, None, dyc)

    # phase 2: da of each chunk's first step is <Gx_{c-1}, S_{c-1}>
    S = s0.float()
    starts = []
    for c in range(nc):
        starts.append(S)
        S = torch.exp(cwl[:, :, c])[..., None, None] * S + dS[:, :, c]
    G = torch.zeros_like(S) if dS_T is None else dS_T.float()
    ends, first = [None] * nc, [None] * nc
    for c in range(nc - 1, -1, -1):
        ends[c] = G
        G = torch.exp(cwl[:, :, c])[..., None, None] * G + dG[:, :, c]
        first[c] = (G * starts[c]).sum((-2, -1))
    dS0 = G
    Sst, Gx = torch.stack(starts, 2), torch.stack(ends, 2)
    first = torch.stack(first, 2)                      # (Bt, H, nc)

    # phase 3
    M = torch.einsum("bcin,bcjn->bcij", Cc, Bc)[:, None] * ex
    W = torch.einsum("bhcip,bhcjp->bhcij", dyc, xc) * ex
    dx = R.mm("bhcij,bhcip->bhcjp", "M", M, None, dyc) \
        + tail * R.mm("bcjn,bhcnp->bhcjp", None, Bc, "G", Gx)
    dBh = R.mm("bhcij,bcin->bhcjn", "W", W, None, Cc) \
        + tail * R.mm("bhcjp,bhcnp->bhcjn", None, xc, "G", Gx)
    dCh = R.mm("bhcij,bcjn->bhcin", "W", W, None, Bc) \
        + torch.exp(cw)[..., None] * R.mm("bhcip,bhcnp->bhcin", None, dyc,
                                          "S", Sst)
    z = (xc * dx).sum(-1) - (Cc[:, None] * dCh).sum(-1)   # (Bt, H, nc, L)
    if prefix == "chunk":
        da = first[..., None] + _excl_cumsum(z, 3)
    else:
        c0 = (s0.float() * dS0).sum((-2, -1))[..., None]
        da = c0 + _excl_cumsum(z.reshape(Bt, H, nc * L), 2)
    cut = lambda t: t.reshape(*t.shape[:2], nc * L, *t.shape[4:])[:, :, :T]  # noqa: E731,E501
    dB = cut(dBh.sum(1)[:, None])[:, 0]
    dC = cut(dCh.sum(1)[:, None])[:, 0]
    return (cut(dx).to(x.dtype), da.reshape(Bt, H, nc * L)[..., :T],
            dB.to(Bm.dtype), dC.to(Cm.dtype), dS0)


# (kernel, dims, decay fill): strong decay, and the blocks' own
CASES = {"wkv6_lw=-8": ("wkv6", (1, 2, 200, 64), -8.0),
         "wkv6_model": ("wkv6", (1, 2, 200, 64), None),
         "ssd_a=-2": ("ssd", (1, 2, 200, 64, 64), -2.0),
         "ssd_model": ("ssd", (1, 2, 200, 64, 64), None)}
_EMULATION = {"wkv6": wkv6_arithmetic, "ssd": ssd_arithmetic}
_NAMES = {"wkv6": WKV6_NAMES, "ssd": SSD_NAMES}


def _case(tag):
    kernel, dims, fill = CASES[tag]
    g = torch.Generator()
    g.manual_seed(sum(dims))
    args, dout, dS = checks.recur_bwd_inputs(g, "cpu", kernel, dims,
                                             torch.bfloat16, 1.0, fill)
    return kernel, args, dout, dS


def _exact(kernel, args, dout, dS):
    plain = ref.wkv6_bwd_ref if kernel == "wkv6" else ref.ssd_bwd_ref
    return plain(*(a.double() for a in args), dout.double(), dS.double())


def _jax(kernel, args, dout, dS):
    fn = wkv6_chunked if kernel == "wkv6" else ssd_chunked
    _, pull = jax.vjp(lambda *a: fn(*a, chunk=10),
                      *(jnp.asarray(a.float().contiguous().numpy())
                        for a in args))
    cot = (jnp.asarray(dout.float().contiguous().numpy()),
           jnp.asarray(dS.numpy()))
    return [torch.from_numpy(np.array(t)) for t in pull(cot)]


_CACHE = {}


def _reference(tag, against):
    if (tag, against) not in _CACHE:
        kernel, args, dout, dS = _case(tag)
        fn = _exact if against == "float64" else _jax
        _CACHE[tag, against] = fn(kernel, args, dout, dS)
    return _CACHE[tag, against]


def _ratios(tag, against="float64", **kw):
    """Per gradient, max |got − exp| / (tol · max |exp|) of the emulation
    (``kw``: its controls) against ``against``."""
    kernel, args, dout, dS = _case(tag)
    got = _EMULATION[kernel](*args, dout, dS, **kw)
    exp = _reference(tag, against)
    out = {}
    for name, a, e in zip(_NAMES[kernel], got, exp):
        assert a.shape == e.shape and bool(torch.isfinite(a).all()), name
        out[name] = (float((a.double() - e.double()).abs().max())
                     / (TOL * float(e.double().abs().max())))
    return out


@pytest.mark.parametrize("against", ["float64", "jax_vjp"])
@pytest.mark.parametrize("tag", sorted(CASES))
def test_bf16_backward_arithmetic_holds_the_bar(tag, against):
    ratios = _ratios(tag, against)
    assert max(ratios.values()) <= 1.0, ratios


@pytest.mark.parametrize("prefix", ["whole", "anchor"])
def test_wkv6_control_dlw_needs_the_reanchored_prefix(prefix):
    """At lw ≡ −8 a dlw is ~e^{−8} of the terms of its prefix.  With the
    kernel's bf16 products, a prefix over all of T, or one re-anchored at
    each chunk from ⟨G, S⟩ that keeps the adjacent pairs (whose two
    roundings then fail to cancel), puts dlw far past the tolerance; the
    other gradients do not move."""
    base = _ratios("wkv6_lw=-8")
    ratios = _ratios("wkv6_lw=-8", prefix=prefix)
    assert base["dlw"] <= 0.5 and ratios["dlw"] > 20.0, (base, ratios)
    assert all(ratios[n] == base[n] for n in WKV6_NAMES if n != "dlw")


@pytest.mark.parametrize("operand", SSD_SPLIT)
def test_ssd_control_one_rounding_of_a_split_operand_breaks_da(operand):
    """At a_log ≡ −2, da is ~e^{−2} of the terms of its prefix: one bf16
    rounding of M (dx) or of W (dB, dC), in place of its hi + lo halves,
    puts da past the tolerance."""
    assert _ratios("ssd_a=-2")["da_log"] <= 0.2
    assert _ratios("ssd_a=-2", once=(operand,))["da_log"] > 1.2
