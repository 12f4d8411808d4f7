"""Runtime sanitizer: NaN / Inf checks on every output, and a generator
stream-reuse tracer (port of ``repro/analysis/sanitize.py``).

``sanitize()`` is the opt-in runtime companion of the static KEY-REUSE
rule.  Inside the context, nothing is written — the run's results are
bitwise those of a run without it — and three things are read:

* **NaN / Inf in every floating output of every ATen op**, through a
  ``TorchDispatchMode`` (views and the uninitialized ``empty`` factories
  excepted: they compute nothing), and in the backward through anomaly
  mode's NaN check.  A hit raises ``FloatingPointError`` naming the op,
  as the reference's ``jax_debug_nans`` / ``jax_debug_infs`` do.
* **Kernel outputs.**  A hand-written kernel writes through ``ctypes``
  into tensors the dispatcher already returned, so no dispatch mode sees
  what it wrote: ``kernels.ops`` calls :data:`kernels.ops.OUTPUT_CHECKS`
  on each wrapper's outputs, and the error names the wrapper
  (``gmm_estep_fused``, ``attention``, …).
* **Stream reuse**, the torch form of the reference's key tracer.  A
  ``torch.Generator`` is a stateful stream: a draw consumes the state it
  starts from.  Every consuming draw (``randn``, ``rand``, ``randint``,
  ``randperm``, ``normal``, ``multinomial``, ``bernoulli``, ``poisson``,
  the ``*_like`` forms, ``Tensor.normal_`` / ``uniform_`` /
  ``exponential_`` / ``random_`` / …, with ``generator=`` or the default
  generator of the output's device) is seen through a
  ``TorchFunctionMode``, which fingerprints that generator's state before
  the draw — seed and offset on the card, the state bytes on the CPU.  A
  draw that starts from a state already consumed raises
  :class:`KeyReuseError` under ``strict`` (and is only counted
  otherwise): two generators seeded alike, or a ``get_state()`` restored
  with ``set_state()`` and drawn from again.  A draw that leaves the
  state where it was (an empty draw) consumes nothing.  Draws made while
  a CUDA graph is being captured have no concrete state to fingerprint
  and are skipped (the reference skips tracers); the static rules cover
  captured code.

Deliberate same-stream comparisons (run A vs run B on one seed) call
``state.reset()`` between the runs; the retry path announces its replays
through :func:`reset_active`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
from typing import Dict, Iterator, List, Optional

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten


class KeyReuseError(RuntimeError):
    """A generator draw started from a state already consumed."""


# states of every live sanitize() context, innermost last — the retry
# path's deliberate-replay hook (reset_active) needs to reach whatever
# sanitizer happens to be armed without threading state through the
# whole federation call stack
_ACTIVE: list = []


def reset_active(reason: str = "") -> int:
    """Forget consumption history in every live sanitizer context.

    The client-phase retry loop (``fl.resilience.call_with_retry``)
    replays an attempt from the same seed on purpose — the attempt builds
    its draw stream afresh from the client's seed, so the replay
    reproduces the message a clean first attempt would have sent.  That
    is exactly what the stream tracer exists to flag, so the retry loop
    announces the replay here (a documented suppression, not a bypass:
    ``n_resets`` records each call, and ``reason`` is kept for the audit
    trail).  Returns the number of live states reset — 0 when no
    sanitizer is armed.
    """
    for state in _ACTIVE:
        state.reset()
        state.n_resets += 1
        if reason:
            state.reset_reasons.append(reason)
    return len(_ACTIVE)


_T = torch.Tensor
# consuming draws → the argument position of a tensor whose device picks
# the default generator (None: a factory, its device= keyword)
_DRAWS = {
    torch.randn: None, torch.rand: None, torch.randint: None,
    torch.randperm: None, torch.normal: 0, torch.multinomial: 0,
    torch.bernoulli: 0, torch.poisson: 0, torch.randn_like: 0,
    torch.rand_like: 0, torch.randint_like: 0,
    _T.normal_: 0, _T.uniform_: 0, _T.exponential_: 0, _T.random_: 0,
    _T.bernoulli_: 0, _T.cauchy_: 0, _T.log_normal_: 0, _T.geometric_: 0,
    _T.bernoulli: 0, _T.multinomial: 0,
    torch.nn.functional.dropout: 0,
}
# outputs that compute nothing: uninitialized memory is not a NaN made
_UNCHECKED = {torch.ops.aten.empty, torch.ops.aten.empty_like,
              torch.ops.aten.empty_strided, torch.ops.aten.new_empty,
              torch.ops.aten.new_empty_strided, torch.ops.aten.set_,
              torch.ops.aten.resize_}


def _capturing() -> bool:
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


def _generator_of(func, args, kwargs) -> Optional[torch.Generator]:
    gen = kwargs.get("generator")
    if gen is not None:
        return gen
    if func is torch.nn.functional.dropout and not kwargs.get(
            "training", args[2] if len(args) > 2 else True):
        return None
    pos = _DRAWS[func]
    dev = None
    if pos is not None and len(args) > pos and torch.is_tensor(args[pos]):
        dev = args[pos].device
    elif torch.is_tensor(kwargs.get("out")):
        dev = kwargs["out"].device
    elif kwargs.get("device") is not None:
        dev = torch.device(kwargs["device"])
    elif torch.is_tensor(kwargs.get("mean")):
        dev = kwargs["mean"].device
    if dev is None:
        dev = torch.get_default_device()
    if dev.type == "cuda":
        index = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        return torch.cuda.default_generators[index]
    if dev.type == "cpu":
        return torch.default_generator
    return None                      # meta: nothing is drawn


def fingerprint(gen: torch.Generator) -> bytes:
    """The state a draw from ``gen`` starts from: seed and offset on the
    card, a digest of the state bytes on the CPU."""
    state = gen.get_state()
    return gen.device.type.encode() + hashlib.blake2b(
        state.numpy().tobytes(), digest_size=16).digest()


@dataclasses.dataclass
class SanitizerState:
    # strict=False records reuse in ``n_errors`` without raising (a lane
    # that counts replays as a metric)
    strict: bool = True
    consumed: Dict[bytes, str] = dataclasses.field(default_factory=dict)
    n_checked: int = 0             # draws fingerprinted
    n_skipped_capture: int = 0     # draws inside a CUDA graph capture
    n_errors: int = 0
    n_resets: int = 0              # reset_active() announcements received
    reset_reasons: list = dataclasses.field(default_factory=list)
    n_values: int = 0              # floating op outputs checked
    kernel_checks: Dict[str, int] = dataclasses.field(default_factory=dict)
    # the streams fingerprinted: (device, initial seed) of each generator
    generators: set = dataclasses.field(default_factory=set)
    nans: bool = True
    infs: bool = True
    busy: bool = False             # inside a check: its own ops pass

    def reset(self) -> None:
        """Forget consumption history (for deliberate same-stream
        replays)."""
        self.consumed.clear()

    @property
    def n_generators(self) -> int:
        """Distinct generator streams fingerprinted (by device and seed)."""
        return len(self.generators)

    def begin_draw(self, fn_name: str, gen: torch.Generator
                   ) -> Optional[bytes]:
        if _capturing():
            self.n_skipped_capture += 1
            return None
        fp = fingerprint(gen)
        self.n_checked += 1
        self.generators.add((str(gen.device), gen.initial_seed()))
        prev = self.consumed.get(fp)
        if prev is not None:
            self.n_errors += 1
            if self.strict:
                raise KeyReuseError(
                    f"generator stream consumed twice: {fn_name} starts "
                    f"from a {gen.device} generator state already consumed "
                    f"by {prev} — two generators seeded alike, or a "
                    f"restored get_state(); derive a distinct seed "
                    f"(state.reset() for deliberate same-stream replays)")
        return fp

    def end_draw(self, fn_name: str, gen: torch.Generator,
                 fp: Optional[bytes]) -> None:
        if fp is not None and fingerprint(gen) != fp:
            self.consumed.setdefault(fp, fn_name)

    def check_values(self, where: str, tree) -> None:
        """Raise ``FloatingPointError`` when a floating tensor in ``tree``
        holds a NaN (``nans``) or an Inf (``infs``).  The check's own ops
        (``isfinite`` decomposes into ``abs`` and compares on the card)
        are not checked again."""
        if self.busy or _capturing():
            return
        self.busy = True
        try:
            self._check_values(where, tree)
        finally:
            self.busy = False

    def _check_values(self, where: str, tree) -> None:
        for i, t in enumerate(tree_flatten(tree)[0]):
            if not (torch.is_tensor(t) and t.is_floating_point()) \
                    or t.is_meta or t.numel() == 0:
                continue
            self.n_values += 1
            if self.nans and self.infs:
                bad = not bool(torch.isfinite(t).all())
            elif self.nans:
                bad = bool(torch.isnan(t).any())
            else:
                bad = bool(torch.isinf(t).any())
            if bad:
                what = "NaN" if self.nans and bool(torch.isnan(t).any()) \
                    else "Inf"
                raise FloatingPointError(
                    f"{what} in output {i} of {where} "
                    f"({tuple(t.shape)} {t.dtype} on {t.device})")

    def check_kernel(self, name: str, outputs) -> None:
        self.kernel_checks[name] = self.kernel_checks.get(name, 0) + 1
        self.check_values(f"kernel wrapper '{name}'", outputs)


class _DrawMode(TorchFunctionMode):
    def __init__(self, state: SanitizerState):
        super().__init__()
        self.state = state

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func not in _DRAWS:
            return func(*args, **kwargs)
        gen = _generator_of(func, args, kwargs)
        if gen is None:
            return func(*args, **kwargs)
        name = func.__name__
        name = f"Tensor.{name}" if getattr(_T, name, None) is func \
            else f"F.{name}" if func is torch.nn.functional.dropout \
            else f"torch.{name}"
        fp = self.state.begin_draw(name, gen)
        out = func(*args, **kwargs)
        self.state.end_draw(name, gen, fp)
        return out


class _ValueMode(TorchDispatchMode):
    def __init__(self, state: SanitizerState):
        super().__init__()
        self.state = state

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and func.overloadpacket not in _UNCHECKED:
            self.state.check_values(f"aten op {func}", out)
        return out


@contextlib.contextmanager
def sanitize(nans: bool = True, infs: bool = True,
             key_reuse: bool = True,
             strict: bool = True) -> Iterator[SanitizerState]:
    """Context manager arming the NaN / Inf checks (ATen ops, the
    backward, kernel outputs) and the generator stream tracer."""
    from repro_torch.kernels import ops

    state = SanitizerState(strict=strict, nans=nans, infs=infs)
    modes: List = []
    anomaly = None
    hook = None
    if nans or infs:
        modes.append(_ValueMode(state))
        hook = state.check_kernel
        ops.OUTPUT_CHECKS.append(hook)
        if nans:
            anomaly = torch.autograd.set_detect_anomaly(True, check_nan=True)
    if key_reuse:
        modes.append(_DrawMode(state))
    _ACTIVE.append(state)
    try:
        with contextlib.ExitStack() as stack:
            for mode in modes:
                stack.enter_context(mode)
            yield state
    finally:
        _ACTIVE.remove(state)
        if hook is not None:
            ops.OUTPUT_CHECKS.remove(hook)
        if anomaly is not None:
            anomaly.__exit__(None, None, None)
