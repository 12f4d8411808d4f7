"""The port's ``fl/round.py`` against ``repro/fl/round.py``.

The round program's inputs are built from byte-identical messages: the
port's ``wire_stack``, ``pad_cohort`` and ``pad_slots`` must equal the
reference's arrays exactly (bf16 compared as bits).  ``round_program`` in
both layouts, fed the reference's draws, must match the reference's
``round_program(key, …)`` within ``tests/test_torch_head.py``'s 1e-4.
Inside the port, bitwise on the CPU: a cohort padded to its canonical
signature (leading count-0 identity clients, absent classes left in the
grid) trains the compacted fused head (DESIGN §11), and
``head.categorical`` makes ``torch.multinomial``'s draws.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import head as JH
from repro.fl import ingest as JI
from repro.fl import round as JR
from repro_torch.core import head as H
from repro_torch.fl import api as A
from repro_torch.fl import ingest as I
from repro_torch.fl import round as FR
from test_torch_head import HEAD_TOL, _reference_fused_draws
from test_torch_resilience import C, D, K, msg_pair

CFG = dict(n_steps=20, batch_size=16, lr=3e-3, noise_window=8)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def _tbits(t):
    t = torch.as_tensor(t)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _cohort(M=3, seed=8):
    pairs = [msg_pair(i, seed) for i in range(M)]
    return [p for p, _ in pairs], [j for _, j in pairs]


def test_signatures_and_next_pow2():
    port, ref = _cohort()
    sig, jsig = FR.signature_of(port), JR.signature_of(ref)
    assert dataclasses.astuple(sig) == dataclasses.astuple(jsig)
    assert dataclasses.astuple(sig.canonical()) == \
        dataclasses.astuple(jsig.canonical())
    assert [FR.next_pow2(n) for n in (1, 2, 3, 5, 64, 65)] == \
        [JR.next_pow2(n) for n in (1, 2, 3, 5, 64, 65)]
    with pytest.raises(ValueError, match="heterogeneous"):
        FR.signature_of(port + [msg_pair(9, dtype="float32")[0]])
    with pytest.raises(ValueError, match="cov_type"):
        FR.CohortSignature(M=1, C=1, K=1, d=1, cov_type="block")


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_wire_stack_and_pad_cohort_are_the_references(dtype):
    pairs = [msg_pair(i, 8, dtype=dtype) for i in range(3)]
    port, ref = [p for p, _ in pairs], [j for _, j in pairs]
    stack, counts = FR.wire_stack(port)
    jstack, jcounts = JR.wire_stack(ref)
    for k in ("pi", "mu", "cov"):
        np.testing.assert_array_equal(_tbits(stack[k]), _bits(jstack[k]))
    np.testing.assert_array_equal(counts, jcounts)
    sig, jsig = FR.signature_of(port), JR.signature_of(ref)
    pstack, pcounts = FR.pad_cohort(stack, counts, sig, sig.canonical())
    jpstack, jpcounts = JR.pad_cohort(jstack, jcounts, jsig,
                                      jsig.canonical())
    for k in ("pi", "mu", "cov"):
        np.testing.assert_array_equal(_tbits(pstack[k]), _bits(jpstack[k]))
    np.testing.assert_array_equal(pcounts, jpcounts)
    assert pcounts.dtype == np.int32 and (pcounts[0] == 0).all()
    with pytest.raises(ValueError, match="padded up"):
        FR.pad_cohort(stack, counts, sig, dataclasses.replace(sig, M=2))


def _states(capacity=12):
    port, ref = _cohort(5, seed=9)
    ps = I.fold_messages(I.IngestState.empty(C, "diag", K, D, capacity, 2),
                         list(enumerate(port)))
    js = JI.fold_messages(JI.IngestState.empty(C, "diag", K, D, capacity,
                                               2), list(enumerate(ref)))
    return ps, js


def test_pad_slots_is_the_references():
    ps, js = _states()
    sig, jsig = FR.signature_of_state(ps), JR.signature_of_state(js)
    assert dataclasses.astuple(sig) == dataclasses.astuple(jsig)
    got = FR.pad_slots(*ps.padded_stack(), sig, sig.canonical())
    want = JR.pad_slots(*js.padded_stack(), jsig, jsig.canonical())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got[1].shape == (16, K, D)


def _close(head, losses, jhead, jlosses):
    for f in ("w", "b"):
        np.testing.assert_allclose(head[f].numpy(), np.asarray(jhead[f]),
                                   rtol=HEAD_TOL, atol=HEAD_TOL)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                               rtol=HEAD_TOL, atol=HEAD_TOL)


def test_round_program_wire_layout_with_the_references_draws():
    port, ref = _cohort()
    sig, jsig = FR.signature_of(port).canonical(), \
        JR.signature_of(ref).canonical()
    stack, counts = FR.pad_cohort(*FR.wire_stack(port),
                                  FR.signature_of(port), sig)
    jstack, jcounts = JR.pad_cohort(*JR.wire_stack(ref),
                                    JR.signature_of(ref), jsig)
    spc = 7
    cfg, jcfg = H.HeadConfig(**CFG), JH.HeadConfig(**CFG)
    key = jax.random.PRNGKey(5)
    jhead, jlosses = JR.round_program(
        key, jnp.asarray(jstack["pi"]), jnp.asarray(jstack["mu"]),
        jnp.asarray(jstack["cov"]), jnp.asarray(jcounts), sig=jsig,
        head_cfg=jcfg, samples_per_class=spc)
    n = sig.M * C
    pi32 = np.asarray(jstack["pi"], np.float32).reshape(n, K)
    n_eff = np.where(jcounts.reshape(n) > 0, spc, 0)
    draws = _reference_fused_draws(key, pi32, n_eff, jcfg, D, C)
    head, losses = FR.round_program(
        stack["pi"], stack["mu"], stack["cov"], torch.from_numpy(counts),
        sig=sig, head_cfg=cfg, samples_per_class=spc, draws=draws)
    _close(head, losses, jhead, jlosses)


def test_round_program_slots_layout_with_the_references_draws():
    ps, js = _states()
    sig = FR.signature_of_state(ps).canonical()
    jsig = JR.signature_of_state(js).canonical()
    args = FR.pad_slots(*ps.padded_stack(), FR.signature_of_state(ps), sig)
    jargs = JR.pad_slots(*js.padded_stack(), JR.signature_of_state(js),
                         jsig)
    cfg, jcfg = H.HeadConfig(**CFG), JH.HeadConfig(**CFG)
    key = jax.random.PRNGKey(6)
    jpi, jmu, jcov, jlab, jcnt = (jnp.asarray(a) for a in jargs)
    jhead, jlosses = JR.round_program(key, jpi, jmu, jcov, jcnt, jlab,
                                      sig=jsig, head_cfg=jcfg)
    draws = _reference_fused_draws(key, jargs[0], jargs[4], jcfg, D, C)
    pi, mu, cov, lab, cnt = (torch.from_numpy(a) for a in args)
    head, losses = FR.round_program(pi, mu, cov, cnt, lab, sig=sig,
                                    head_cfg=cfg, draws=draws)
    _close(head, losses, jhead, jlosses)
    with pytest.raises(ValueError, match="slot_labels"):
        FR.round_program(pi, mu, cov, cnt, sig=sig, head_cfg=cfg,
                         draws=draws)


@pytest.mark.parametrize("absent", [False, True])
def test_padded_cohort_trains_the_compacted_head_bitwise(absent):
    """DESIGN §11 in the port: leading identity clients and absent
    classes are count-0 rows the slot draw never lands on."""
    counts = [5, 0, 12, 3] if absent else None
    port = [msg_pair(i, 10, counts=counts)[0] for i in range(3)]
    cfg = H.HeadConfig(**CFG)
    sig = FR.signature_of(port)
    stack, cnt = FR.pad_cohort(*FR.wire_stack(port), sig, sig.canonical())
    g = torch.Generator()
    g.manual_seed(3)
    head, losses = FR.round_program(stack["pi"], stack["mu"], stack["cov"],
                                    torch.from_numpy(cnt),
                                    sig=sig.canonical(), head_cfg=cfg,
                                    generator=g)
    slots, labels, scounts, _ = A.fused_slot_stack(
        A.stack_messages(port), np.stack([m.counts for m in port]))
    g2 = torch.Generator()
    g2.manual_seed(3)
    want, wlosses = H.train_head_from_gmms(
        slots["pi"], slots["mu"], slots["cov"], labels, scounts, C, cfg,
        "diag", device="cpu", generator=g2)
    for f in ("w", "b"):
        assert torch.equal(head[f], want[f])
    assert torch.equal(losses, wlosses)
    assert torch.equal(g.get_state(), g2.get_state())


def test_categorical_makes_multinomials_draws():
    p = torch.rand(500, 7).clamp_min(1e-20)
    for seed in (0, 9):
        g1, g2 = torch.Generator(), torch.Generator()
        g1.manual_seed(seed)
        g2.manual_seed(seed)
        assert torch.equal(H.categorical(p, g1),
                           torch.multinomial(p, 1, generator=g2)[:, 0])
        assert torch.equal(g1.get_state(), g2.get_state())
