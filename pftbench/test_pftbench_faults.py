"""The comparison against what it must catch, on the CPU at a tiny size: a
sound run comes out correct under each round cell's limits; the control (the
reference one precision step down in the program's place) and each fault a
round or the service can have, planted under the timed path, come out not
correct."""
import pytest
import torch

from pftbench import bench, faults, testing
from pftbench.control import check_control

CELLS = [("hubert-xlarge.round", testing.ENCODER),
         ("zamba2-7b.round", testing.HYBRID)]


def _limits(name):
    return bench.load_json(bench.HERE / "limits" / f"{name}.json")


def _correct(numbers, name):
    return bench.passed(bench.judge(numbers, _limits(name)))


@pytest.mark.parametrize("name, model", CELLS)
def test_a_sound_run_is_correct(name, model):
    rec = testing.run(testing.cell(model))
    assert _correct(rec["numbers"], name), rec["numbers"]


@pytest.mark.parametrize("name, model", CELLS)
def test_the_control_is_not_correct(name, model):
    from pftbench.workloads import round as R
    cell = testing.cell(model)
    rounds = R.Rounds(cell["config_file"]["model"], cell["mix"], 2**31 + 3,
                      "cpu")
    out = rounds.run(0)
    numbers = check_control(rounds, out)
    assert not _correct(numbers, name), numbers


def _adam_unchanged(monkeypatch):
    from repro_torch.core import head as H
    monkeypatch.setattr(H, "_adam_step", lambda params, opt_state, opt, x, y,
                        weights: (params, opt_state, torch.zeros(())))


def _half_batch(monkeypatch):
    from repro_torch.core import head as H
    orig = H._xent

    def xent(params, feats, labels, weights):
        n = feats.shape[0] // 2
        return orig(params, feats[:n], labels[:n], weights[:n])
    monkeypatch.setattr(H, "_xent", xent)


def _features_altered(monkeypatch):
    from repro_torch.models import model as M
    orig = M.features
    monkeypatch.setattr(M, "features", lambda *a, **k: orig(*a, **k) * 1.5)


def _wire_altered(monkeypatch):
    faults.wire_altered(monkeypatch.setattr)


def _em_unchanged(monkeypatch):
    faults.em_unchanged(monkeypatch.setattr)


def _labels_shifted(monkeypatch):
    faults.labels_shifted(monkeypatch.setattr)


@pytest.mark.parametrize("fault", [_adam_unchanged, _half_batch,
                                   _features_altered, _wire_altered,
                                   _em_unchanged])
@pytest.mark.parametrize("name, model", CELLS)
def test_a_fault_under_the_timed_path_is_not_correct(name, model, fault,
                                                     monkeypatch):
    fault(monkeypatch)
    rec = testing.run(testing.cell(model))
    assert not _correct(rec["numbers"], name), rec["numbers"]


SERVICE = "zamba2-7b.service"


def test_a_sound_service_run_is_correct():
    rec = testing.run_service(testing.service_cell())
    assert rec["failed"] == 0 and _correct(rec["numbers"], SERVICE), \
        rec["numbers"]


def test_the_service_control_is_not_correct():
    from pftbench.control import service_control
    from pftbench.workloads import service as S
    cell = testing.service_cell()
    svc = S.Service(cell["config_file"]["model"], cell["mix"], 2**31 + 5,
                    0.2, "cpu")
    svc.warm_up()
    out = svc.window()
    numbers = service_control(svc, out)
    assert not _correct(numbers, SERVICE), numbers


def _half_the_rows(monkeypatch):
    """A step leaves out the first half of its rows, which get the hidden
    states of the rest."""
    from repro_torch.models import model as M
    orig = M.final_hidden

    def hidden(cfg, params, batch):
        h = orig(cfg, params, batch)
        B = h.shape[0]
        return torch.cat([h[B // 2:], h[B // 2:]])[:B]
    monkeypatch.setattr(M, "final_hidden", hidden)


def _hidden_altered(monkeypatch):
    from repro_torch.models import model as M
    orig = M.final_hidden
    monkeypatch.setattr(M, "final_hidden", lambda *a: orig(*a) * 1.5)


@pytest.mark.parametrize("fault", [_half_the_rows, _hidden_altered,
                                   _wire_altered, _em_unchanged,
                                   _labels_shifted])
def test_a_fault_under_the_served_path_is_not_correct(fault, monkeypatch):
    from pftbench.workloads import service as S
    cell = testing.service_cell()
    svc = S.Service(cell["config_file"]["model"], cell["mix"], 2**31 + 6,
                    0.2, "cpu")
    svc.warm_up()                   # the served head from a sound round
    fault(monkeypatch)
    out = svc.window()
    assert not _correct(S.check(svc, out), SERVICE)
