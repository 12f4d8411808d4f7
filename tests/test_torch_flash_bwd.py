"""Flash attention's backward, on the CPU: the plain versions that the
kernel is held to on the card, against the JAX package, and the backward
kernel's query-tile rule against the mask.

``ref.attention_bwd_ref`` (the FlashAttention-2 formulas, on the forward's
o and lse) and ``ref.attention_lse_ref`` against ``jax.vjp`` of
``repro.kernels.ref.attention_ref`` and the logsumexp of its masked
scores, in f32 from numpy inputs: causal, window, prefix, GQA, queries at
the tail of more keys, bidirectional, and the wide heads (D = 160, 192) with
GQA.  Tolerance 1e-5 × each gradient's largest value (the two sum in
their own orders; ≈ 1e-7 apart here) and 1e-5 on the lse.
``flash_attention.query_tile_range`` decides which query tiles the dK/dV
block of a key tile walks, and ``flash_attention_bwd.piece_visibility``
which pieces of a tile a warp skips or tests pair by pair
(``csrc/flash_attention_bwd.cu`` states the same arithmetic): over a grid
of small shapes and masks, every query tile holding a row that sees a key
of the tile is walked and no other, and a piece's two answers are those of
the mask.  Exact: integer rules.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as JR
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import BKV, BQ, query_tile_range
from repro_torch.kernels.flash_attention_bwd import piece_visibility

CASES = [
    # B, H, Hkv, Sq, Sk, D, causal, window, prefix
    (2, 4, 2, 24, 24, 16, True, 0, 0),       # causal, GQA
    (1, 2, 2, 20, 20, 16, True, 6, 0),       # sliding window
    (1, 4, 4, 24, 24, 16, True, 0, 5),       # prefix
    (1, 2, 2, 24, 24, 16, True, 5, 3),       # window and prefix
    (1, 4, 1, 8, 24, 32, True, 0, 0),        # MQA, queries at the tail
    (2, 2, 2, 20, 20, 16, False, 0, 0),      # bidirectional
    (1, 2, 2, 20, 20, 16, False, 7, 0),      # bidirectional window
    (1, 4, 1, 20, 20, 160, True, 0, 0),      # pixtral-12b's head dim, GQA
    (1, 4, 2, 18, 22, 192, True, 0, 0),      # nemotron-4-340b's, GQA, tail
]


@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,D,causal,window,prefix", CASES)
def test_plain_backward_and_lse_match_jax_vjp(B, H, Hkv, Sq, Sk, D, causal,
                                              window, prefix):
    rs = np.random.RandomState(Sq + Sk + D + window + prefix)
    q, do = (rs.randn(B, H, Sq, D).astype(np.float32) for _ in range(2))
    k, v = (rs.randn(B, Hkv, Sk, D).astype(np.float32) for _ in range(2))
    kw = dict(causal=causal, window=window, prefix=prefix)
    mask = jnp.asarray(ref.attention_mask(Sq, Sk, **kw).numpy())

    @jax.jit
    def reference(q, k, v, do):
        o, vjp = jax.vjp(lambda a, b, c: JR.attention_ref(a, b, c, **kw),
                         q, k, v)
        # the logsumexp of the visible scaled scores
        s = jnp.einsum("bhgqd,bhkd->bhgqk",
                       q.reshape(B, Hkv, H // Hkv, Sq, D), k) / np.sqrt(D)
        lse = jax.nn.logsumexp(jnp.where(mask, s, -jnp.inf), axis=-1)
        return o, lse, vjp(do)
    o, jlse, jgrads = reference(*(jnp.asarray(a) for a in (q, k, v, do)))
    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    lse = ref.attention_lse_ref(t[0], t[1], **kw)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse).reshape(
        B, H, Sq), rtol=1e-5, atol=1e-5)
    got = ref.attention_bwd_ref(t[0], t[1], t[2],
                                torch.from_numpy(np.array(o)), lse, t[3],
                                **kw)
    for name, a, e in zip(("dq", "dk", "dv"), got, jgrads):
        e = np.asarray(e)
        assert a.shape == e.shape and a.dtype == torch.float32, name
        err = float(np.abs(a.numpy() - e).max())
        assert err <= 1e-5 * float(np.abs(e).max()), (name, err)


def test_plain_backward_is_autograd_of_the_plain_forward():
    """On the CPU ``ops.attention`` trains by autograd of
    ``ref.attention_ref``: the same gradients as the formulas."""
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(*s, generator=g) for s in (
        (2, 4, 20, 16), (2, 2, 20, 16), (2, 2, 20, 16), (2, 4, 20, 16)))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = ops.attention(*leaves, causal=True, window=7)
    o.backward(do)
    got = ref.attention_bwd_ref(q, k, v, o.detach(),
                                ref.attention_lse_ref(q, k, window=7), do,
                                window=7)
    for a, t in zip(got, leaves):
        torch.testing.assert_close(a, t.grad, rtol=1e-5, atol=1e-5)


def test_rows_with_no_visible_key_get_no_gradient():
    """Sq > Sk, causal: the first rows see no key.  Their lse is −inf and
    P = 0 there, so dq is 0 and they add nothing to dk, dv."""
    g = torch.Generator().manual_seed(1)
    q, do = (torch.randn(1, 2, 12, 16, generator=g) for _ in range(2))
    k, v = (torch.randn(1, 2, 5, 16, generator=g) for _ in range(2))
    lse = ref.attention_lse_ref(q, k)
    assert torch.isinf(lse[:, :, :7]).all() and torch.isfinite(
        lse[:, :, 7:]).all()
    o = ref.attention_ref(q, k, v)
    dq, dk, dv = ref.attention_bwd_ref(q, k, v, o, lse, do)
    assert float(dq[:, :, :7].abs().sum()) == 0.0
    dq2, dk2, dv2 = ref.attention_bwd_ref(q[:, :, 7:], k, v, o[:, :, 7:],
                                          lse[:, :, 7:], do[:, :, 7:])
    torch.testing.assert_close(dk, dk2)
    torch.testing.assert_close(dv, dv2)


SEQS = [(1, 1), (5, 5), (64, 64), (65, 65), (130, 130), (200, 200),
        (1, 515), (70, 515), (64, 200), (200, 64)]
MASKS = [(c, w, p) for c in (True, False) for w in (0, 1, 10, 64, 100)
         for p in (0, 3, 64, 70, 130)]


@pytest.mark.parametrize("Sq,Sk", SEQS)
def test_query_tile_range_walks_exactly_the_tiles_that_see_a_key(Sq, Sk):
    for causal, window, prefix in MASKS:
        mask = ref.attention_mask(Sq, Sk, causal=causal, window=window,
                                  prefix=prefix)
        for kt in range(-(-Sk // BKV)):
            lo, hi = query_tile_range(kt, Sq, Sk, causal, window, prefix)
            assert 0 <= lo <= hi <= -(-Sq // BQ)
            sees = mask[:, kt * BKV:(kt + 1) * BKV].any(-1)
            want = [qt for qt in range(-(-Sq // BQ))
                    if sees[qt * BQ:(qt + 1) * BQ].any()]
            assert list(range(lo, hi)) == want, (Sq, Sk, kt, causal,
                                                 window, prefix)


# (rows, keys) of the pieces the bf16 warps classify: a dK/dV warp's 16
# keys against its query steps of 64, 32 or 16, a dQ warp's 16 rows
# against a key tile of 64
PIECES = [(64, 16), (32, 16), (16, 16), (16, 64)]


@pytest.mark.parametrize("Sq,Sk", SEQS)
def test_piece_visibility_is_the_mask_of_each_piece(Sq, Sk):
    """Every piece of every tile: some pair visible exactly when the mask
    has one there (rows past Sq and keys past Sk see nothing), every pair
    exactly when the whole piece lies inside (Sq, Sk) and the mask holds
    throughout."""
    for causal, window, prefix in MASKS:
        mask = ref.attention_mask(Sq, Sk, causal=causal, window=window,
                                  prefix=prefix).numpy()
        for rows, keys in PIECES:
            nq, nk = -(-Sq // rows), -(-Sk // keys)
            full = np.zeros((nq * rows, nk * keys), dtype=bool)
            full[:Sq, :Sk] = mask
            blocks = full.reshape(nq, rows, nk, keys)
            some, every = blocks.any((1, 3)), blocks.all((1, 3))
            for i in range(nq):
                for j in range(nk):
                    got = piece_visibility(i * rows, (i + 1) * rows - 1,
                                           j * keys, (j + 1) * keys - 1, Sq,
                                           Sk, causal, window, prefix)
                    assert got == (some[i, j], every[i, j]), (
                        Sq, Sk, causal, window, prefix, rows, keys, i, j)
