"""``rms_norm_kernel_share.round``: the share of the features' normalised
rows on the card that the one-pass kernel took, from a snapshot made by
hand; None on another kind of run, on an untraced run, on a program
without ``repro_torch.obs`` and on a program that counts no such rows (the
parent of the kernel)."""
import sys

import pytest

from pftbench import bench

TRACED = {"kind": "round", "trace": {"busy_s": 1.0}}


def _read(rec):
    return bench._module(bench.HERE / "metrics"
                         / "rms_norm_kernel_share.round.py").read(rec)


def _snap(monkeypatch, counters):
    from repro_torch import obs
    monkeypatch.setattr(obs, "snapshot",
                        lambda: {"spans": [], "counters": counters})


@pytest.mark.parametrize("counters, want", [
    ({"kernels.rms_norm.rows": 300, "model.rms_norm.plain_rows": 100}, 75.0),
    ({"kernels.rms_norm.rows": 300}, 100.0),
    ({"model.rms_norm.plain_rows": 100}, 0.0),
    ({"fl.server.head_steps": 10}, None),
    ({}, None),
])
def test_the_share_of_kernel_rows(monkeypatch, counters, want):
    _snap(monkeypatch, counters)
    got = _read(TRACED)
    assert got == (None if want is None else pytest.approx(want))


def test_none_on_a_service_run_or_untraced(monkeypatch):
    _snap(monkeypatch, {"kernels.rms_norm.rows": 300})
    assert _read({"kind": "service", "trace": {"busy_s": 1.0}}) is None
    assert _read({"kind": "round"}) is None
    assert _read({"kind": "round", "trace": None}) is None


def test_none_without_the_programs_counters(monkeypatch):
    import repro_torch
    monkeypatch.delattr(repro_torch, "obs")
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)
    assert _read(TRACED) is None
