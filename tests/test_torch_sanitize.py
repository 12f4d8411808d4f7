"""The port's runtime sanitizer (``repro_torch.analysis.sanitize``).

Each shared scenario runs under the reference's ``sanitize()`` with JAX
keys and under the port's with ``torch.Generator`` streams, and must end
the same way on both sides — a double consume, a derive-then-draw, a
reset that allows a replay, a NaN made by an op.  Then the port's own
contract: a restored state raises, an empty draw consumes nothing, a
kernel wrapper's NaN output is named by the wrapper, the modes are gone
on exit, a sanitized round is bitwise the plain one, and the retry path
announces its replays (``fl.resilience.call_with_retry``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import _get_current_function_mode_stack

from repro.analysis import KeyReuseError as JKeyReuseError
from repro.analysis import sanitize as jsanitize
from repro_torch.analysis import KeyReuseError, reset_active, sanitize
from repro_torch.core import gmm as G
from repro_torch.core import head as H
from repro_torch.fl import api as A
from repro_torch.fl import faults as F
from repro_torch.fl import resilience as R
from repro_torch.kernels import ops, ref


def _gen(seed):
    return torch.Generator().manual_seed(seed)


# each scenario: (the reference's body, the port's body); a body raises
# or returns, under its side's sanitizer
def _double_consume_ref():
    k = jax.random.PRNGKey(123)
    jax.random.normal(k, (2,))
    jax.random.uniform(k, (2,))


def _double_consume_port():
    torch.randn(2, generator=_gen(123))
    torch.rand(2, generator=_gen(123))        # a second stream seeded alike


def _derive_ref():
    ka, kb = jax.random.split(jax.random.PRNGKey(7))
    jax.random.normal(ka, (2,))
    jax.random.normal(kb, (2,))


def _derive_port():
    parent = _gen(7)
    sa, sb = torch.randint(0, 2 ** 62, (2,), generator=parent).tolist()
    torch.randn(2, generator=_gen(sa))
    torch.randn(2, generator=_gen(sb))


def _nan_ref():
    return jnp.float32(0.0) / jnp.float32(0.0)


def _nan_port():
    return torch.tensor(0.0) / torch.tensor(0.0)


SCENARIOS = {
    "double_consume": (_double_consume_ref, _double_consume_port,
                       "reuse", dict(nans=False, infs=False)),
    "derive_then_draw": (_derive_ref, _derive_port, None,
                         dict(nans=False, infs=False)),
    "nan_in_an_op": (_nan_ref, _nan_port, "nan", dict(key_reuse=False)),
}
RAISES = {"reuse": (JKeyReuseError, KeyReuseError),
          "nan": (FloatingPointError, FloatingPointError)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_the_reference(name):
    ref_body, port_body, outcome, kw = SCENARIOS[name]
    states = []
    for side, (san, body) in enumerate(((jsanitize, ref_body),
                                        (sanitize, port_body))):
        with san(**kw) as st:
            if outcome is None:
                body()
            else:
                with pytest.raises(RAISES[outcome][side]):
                    body()
        states.append(st)
    assert states[0].n_errors == states[1].n_errors
    if kw.get("key_reuse", True):
        assert states[1].n_checked >= 2 and states[0].n_checked >= 2


def test_non_strict_counts_without_raising_on_both_sides():
    with jsanitize(nans=False, infs=False, strict=False) as js:
        _double_consume_ref()
    with sanitize(nans=False, infs=False, strict=False) as ts:
        _double_consume_port()
    assert js.n_errors == ts.n_errors == 1


def test_reset_allows_a_deliberate_replay_on_both_sides():
    with jsanitize(nans=False, infs=False) as js:
        k = jax.random.PRNGKey(5)
        a = jax.random.normal(k, (2,))
        js.reset()
        b = jax.random.normal(k, (2,))
    assert jnp.array_equal(a, b)
    with sanitize(nans=False, infs=False) as ts:
        x = torch.randn(2, generator=_gen(5))
        ts.reset()
        y = torch.randn(2, generator=_gen(5))
    assert torch.equal(x, y) and js.n_errors == ts.n_errors == 0


def test_restored_state_raises_and_an_empty_draw_consumes_nothing():
    g = _gen(3)
    with sanitize(nans=False, infs=False) as st:
        torch.randn(0, generator=g)             # consumes nothing
        saved = g.get_state()
        torch.randn(3, generator=g)
        torch.empty(4).normal_(generator=g)      # the stream goes on
        g.set_state(saved)
        with pytest.raises(KeyReuseError, match="already consumed"):
            torch.randn(3, generator=g)
    assert st.n_errors == 1 and st.n_generators == 1


def test_default_generator_draws_are_fingerprinted():
    with sanitize(nans=False, infs=False) as st:
        torch.manual_seed(11)
        torch.randn(2)
        torch.manual_seed(11)
        with pytest.raises(KeyReuseError):
            torch.rand(2)
    assert st.n_checked == 2


def test_a_kernel_wrappers_nan_is_named_by_the_wrapper(monkeypatch):
    """A kernel writes where no dispatch mode looks: ``ops`` hands each
    wrapper's outputs to the sanitizer, which names the wrapper."""
    out = torch.zeros(2, 5, 3)
    out[1, 2, 0] = float("nan")
    lse = torch.zeros(2, 5)
    monkeypatch.setattr(ref, "estep_fused_ref", lambda *a: (out, lse))
    x = torch.zeros(2, 5, 4)
    mu, var, pi = torch.zeros(2, 3, 4), torch.ones(2, 3, 4), \
        torch.full((2, 3), 1 / 3)
    with sanitize() as st:
        with pytest.raises(FloatingPointError, match="gmm_estep_fused"):
            ops.gmm_estep_fused(x, mu, var, pi)
    assert st.kernel_checks == {"gmm_estep_fused": 1}
    assert ops.OUTPUT_CHECKS == []


def test_inf_in_attention_inputs_raises():
    q = torch.zeros(1, 2, 4, 16)
    q[0, 1, 2, 3] = float("inf")
    with sanitize(key_reuse=False):
        with pytest.raises(FloatingPointError):
            ops.attention(q, q, q, causal=True)


def test_nan_in_the_backward_raises():
    w = torch.tensor([1.0, -1.0], requires_grad=True)
    with sanitize(infs=False, key_reuse=False):
        y = torch.sqrt(w.detach().abs() * 0.0)  # 0, finite
        with pytest.raises((RuntimeError, FloatingPointError)):
            (torch.sqrt(w) * 0.0).sum().backward()
    assert y.sum() == 0


def test_modes_and_hooks_are_gone_on_exit():
    before = len(_get_current_function_mode_stack())
    anomaly = torch.is_anomaly_enabled()
    with sanitize():
        assert len(_get_current_function_mode_stack()) == before + 1
        assert torch.is_anomaly_enabled()
        assert len(ops.OUTPUT_CHECKS) == 1
    assert len(_get_current_function_mode_stack()) == before
    assert torch.is_anomaly_enabled() == anomaly
    assert ops.OUTPUT_CHECKS == []
    assert reset_active("nothing armed") == 0


C, K, D = 4, 2, 8


def _clients(m, seed=0, n=40):
    rng = np.random.default_rng(seed)
    return [(torch.from_numpy(rng.normal(size=(n, D)).astype(np.float32)
                              + np.eye(C, D)[i % C] * 3),
             torch.from_numpy(rng.integers(0, C, n).astype(np.int64)))
            for i in range(m)]


def _session(**kw):
    return A.FedSession(
        n_classes=C, summarizer=A.GMMSummarizer(G.GMMConfig(K, "diag",
                                                            n_iter=4)),
        head=H.HeadConfig(n_steps=12, batch_size=16, lr=3e-3), **kw)


def test_a_sanitized_round_is_bitwise_the_plain_one():
    data = _clients(4, seed=3)
    plain = _session().run(data, seed=4, device="cpu")
    with sanitize(strict=True) as st:
        res = _session().run(data, seed=4, device="cpu")
    for k in ("w", "b"):
        assert torch.equal(res.model[k], plain.model[k])
    assert st.n_errors == 0 and st.n_checked > 0 and st.n_values > 0
    assert st.kernel_checks["gmm_estep_fused"] > 0
    assert st.n_generators >= 5               # the server and four clients


class TestRetryUnderTheSanitizer:
    def test_call_with_retry_announces_each_replay(self):
        """An attempt draws its client's stream afresh, then fails: the
        replay starts from a consumed state, which the tracer would flag
        but for the retry loop's announcement."""
        attempts = []

        def attempt():
            g = A.round_generator(9, 1, torch.device("cpu"))
            x = torch.randn(4, generator=g)
            attempts.append(x)
            if len(attempts) < 3:
                raise R.TransientClientError("flaky")
            return x

        cfg = R.ResilienceConfig(max_retries=2)
        with sanitize(strict=True) as st:
            ok, x, n, _ = R.call_with_retry(attempt, cfg)
        assert ok and n == 3 and torch.equal(x, attempts[0])
        assert st.n_resets == 2 and st.n_errors == 0
        assert all("retry attempt" in r for r in st.reset_reasons)
        # the control: the same replay without the announcement raises
        with sanitize(strict=True):
            attempt()
            with pytest.raises(KeyReuseError):
                attempt()

    def test_star_round_with_a_flaky_client_under_strict(self):
        data = _clients(3, seed=1)
        clean = _session().run(data, seed=2, device="cpu")
        sess = _session(resilience=R.ResilienceConfig(max_retries=1))
        object.__setattr__(sess, "client_update",
                           F.flaky(sess.client_update, 1))
        with sanitize(strict=True) as st:
            res = sess.run(data, seed=2, device="cpu")
        for k in ("w", "b"):
            assert torch.equal(res.model[k], clean.model[k])
        assert res.info["faults"]["retries"] == 1
        assert st.n_resets == 1 and st.n_errors == 0
