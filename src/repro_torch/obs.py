"""Spans and counters at the program's layer boundaries, on the profiler's
clock.

Tracing is on exactly while a ``torch.profiler`` records
(``torch.autograd._profiler_enabled()``); there is no other switch.  While
it is off a span is one flag check and the shared no-op object, a counter
one flag check: no ``record_function``, no CUDA event, no synchronize.
While it is on, a span

* opens ``torch.profiler.record_function("repro_torch." + name)``, so it
  lies in the profiler's own trace beside the device's kernels;
* appends ``(name, t0_ns, t1_ns, parent, rid)`` to an in-memory list, on
  ``time.time_ns()``, the clock the profiler's events are given on: the
  profiler's event lies inside ``[t0_ns, t1_ns]``;
* with ``device`` on a CUDA device, records a pair of CUDA timing events
  on the device's current stream (none while a CUDA graph is captured),
  resolved only by :func:`snapshot`, after the traced window.

Spans nest: ``parent`` is the index of the enclosing span of the same
thread.  The spans of one service request carry its ``rid``.

    with obs.span("fl.client.em", device=x):
        ...
    obs.count("fl.client.em_iters", cfg.n_iter)
    snap = obs.snapshot()    # {"spans": [...], "counters": {...}}

A site whose caller needs the duration whether or not tracing is on
(``info["phase_s"]``) asks for ``timed=True``: its span then measures on
the same clock with tracing off too, as a bare timer.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Union

import torch
from torch.autograd import _profiler_enabled

PREFIX = "repro_torch."

# one record a span: [name, t0_ns, t1_ns, parent, rid, None for a host
# span, else its (start, end) CUDA events until snapshot() resolves them to
# their elapsed ms]
_SPANS: List[list] = []
_COUNTERS: Dict[str, int] = {}
_LOCAL = threading.local()


class _Off:
    """The span while tracing is off: nothing recorded, nothing timed."""
    __slots__ = ()
    seconds = 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Timer:
    """A ``timed`` span while tracing is off: its host duration alone."""
    __slots__ = ("t0", "seconds")

    def __enter__(self):
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.seconds = (time.time_ns() - self.t0) * 1e-9
        return False


def _stack() -> list:
    st = getattr(_LOCAL, "stack", None)
    if st is None:
        st = _LOCAL.stack = []
    return st


def _cuda(device) -> Optional[torch.device]:
    """The CUDA device of ``device`` (a tensor, a device or None), or
    None."""
    if isinstance(device, torch.Tensor):
        device = device.device
    return device if device is not None and device.type == "cuda" else None


class _Span:
    """A span while tracing is on."""
    __slots__ = ("name", "rid", "device", "rf", "rec", "start", "seconds")

    def __init__(self, name: str, rid, device):
        self.name, self.rid, self.device = name, rid, device

    def __enter__(self):
        st = _stack()
        self.rec = [self.name, time.time_ns(), 0, st[-1] if st else None,
                    self.rid, None]
        st.append(len(_SPANS))
        _SPANS.append(self.rec)
        self.rf = torch.profiler.record_function(PREFIX + self.name)
        self.rf.__enter__()
        dev = _cuda(self.device)
        if dev is not None and torch.cuda.is_current_stream_capturing():
            dev = None
        self.device = dev
        if dev is not None:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record(torch.cuda.current_stream(dev))
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if self.device is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(self.device))
            rec[5] = (self.start, end)
        self.rf.__exit__(*exc)
        rec[2] = time.time_ns()
        _stack().pop()
        self.seconds = (rec[2] - rec[1]) * 1e-9
        return False


def span(name: str, *, rid: Optional[int] = None,
         device: Union[None, torch.Tensor, torch.device] = None,
         timed: bool = False):
    """A context manager over one piece of work named ``name``.

    ``device``: a tensor, or a device, whose CUDA device also times the
    span by CUDA events.  ``timed``: the caller reads ``.seconds`` (the
    host duration) after the block, whether or not tracing is on.
    """
    if not _profiler_enabled():
        return _Timer() if timed else _OFF
    return _Span(name, rid, device)


def interval(name: str, t0_ns: int, t1_ns: int,
             rid: Optional[int] = None) -> None:
    """Record a span that is already over (a request's time in a queue,
    which no ``with`` block covers), on ``time.time_ns()``'s clock."""
    if _profiler_enabled():
        _SPANS.append([name, t0_ns, t1_ns, None, rid, None])


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while tracing is on."""
    if _profiler_enabled():
        _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def snapshot() -> Dict:
    """Every span recorded since :func:`reset` and the counters:
    ``{"spans": [{name, t0_ns, t1_ns, parent, rid, device_ms}],
    "counters": {name: n}}``.  ``device_ms`` is the elapsed time of a
    device span's CUDA events (None for a host span); the events are
    waited for here, once, and then dropped."""
    out = []
    for rec in list(_SPANS):
        if isinstance(rec[5], tuple):
            start, end = rec[5]
            end.synchronize()
            rec[5] = float(start.elapsed_time(end))
        name, t0, t1, parent, rid, ms = rec
        out.append({"name": name, "t0_ns": t0, "t1_ns": t1,
                    "parent": parent, "rid": rid, "device_ms": ms})
    return {"spans": out, "counters": dict(_COUNTERS)}


def reset() -> None:
    """Drop every recorded span and counter."""
    _SPANS.clear()
    _COUNTERS.clear()
