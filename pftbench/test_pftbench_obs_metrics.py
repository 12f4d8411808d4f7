"""The readers of the program's spans and counters: each gives its value from
a snapshot made by hand, and None on another kind of run, on an untraced
run, and on a program without ``repro_torch.obs``."""
import sys

import numpy as np
import pytest

from pftbench import bench


def _span(name, ms=None, t0=0, t1=0):
    return {"name": name, "t0_ns": t0, "t1_ns": t1, "parent": None,
            "rid": None, "device_ms": ms}


WAITS_MS = [0.0, 0.0, 2.0, 5.0, 600.0]
SNAP = {
    "spans": [_span("fl.server.head", 30.0), _span("fl.server.head", 20.0),
              _span("fl.server", None),
              _span("fl.client.em", 4.0), _span("fl.client.em", 8.0),
              _span("model.mamba_block", 20.0),
              _span("model.mamba_block", 24.0),
              _span("model.transformer_block", 3.0),
              _span("model.transformer_block", 4.0),
              _span("model.transformer_block", 5.0)]
    + [_span("serve.queued", None, 1_000, 1_000 + int(w * 1e6))
       for w in WAITS_MS],
    "counters": {"fl.server.head_steps": 10, "fl.client.em_iters": 6,
                 "serve.real_tokens": 48, "serve.slot_positions": 100},
}

CASES = [
    ("head_step_ms.round", "round", 50.0 / 10),
    ("em_iter_ms.round", "round", 12.0 / 6),
    ("mamba_block_ms.round", "round", 22.0),
    ("transformer_block_ms.round", "round", 4.0),
    ("queue_wait_p95_ms.service", "service", float(np.percentile(WAITS_MS,
                                                                 95))),
    ("real_token_share.service", "service", 48.0),
]


def _reader(name):
    return bench._module(bench.HERE / "metrics" / f"{name}.py").read


@pytest.fixture
def snap(monkeypatch):
    from repro_torch import obs
    monkeypatch.setattr(obs, "snapshot", lambda: SNAP)


@pytest.mark.parametrize("name, kind, want", CASES)
def test_each_reader_reads_the_snapshot(snap, name, kind, want):
    assert _reader(name)({"kind": kind, "trace": {"busy_s": 1.0}}) \
        == pytest.approx(want)


@pytest.mark.parametrize("name, kind, want", CASES)
def test_each_reader_is_none_on_another_kind_or_untraced(snap, name, kind,
                                                         want):
    read = _reader(name)
    other = "service" if kind == "round" else "round"
    assert read({"kind": other, "trace": {"busy_s": 1.0}}) is None
    assert read({"kind": kind}) is None
    assert read({"kind": kind, "trace": None}) is None


@pytest.mark.parametrize("name, kind, want", CASES)
def test_each_reader_is_none_without_the_programs_spans(snap, monkeypatch,
                                                        name, kind, want):
    import repro_torch
    monkeypatch.delattr(repro_torch, "obs")
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)
    assert _reader(name)({"kind": kind, "trace": {"busy_s": 1.0}}) is None


@pytest.mark.parametrize("name, kind, want", CASES)
def test_each_reader_is_none_on_an_empty_snapshot(monkeypatch, name, kind,
                                                  want):
    from repro_torch import obs
    monkeypatch.setattr(obs, "snapshot",
                        lambda: {"spans": [], "counters": {}})
    assert _reader(name)({"kind": kind, "trace": {"busy_s": 1.0}}) is None
