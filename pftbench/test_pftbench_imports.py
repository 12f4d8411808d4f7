"""What the benchmark may load and how its pieces are found: no module it runs
loads the JAX stack or the JAX package (top-level names compared whole), the
references import nothing of the program, and every cell of
``BENCHMARK.json`` finds its configuration, mix, limits and readers."""
import ast
import json
import re
import subprocess
import sys

import pytest

from pftbench import bench

HERE = bench.HERE
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _modules():
    return sorted(p for p in HERE.rglob("*.py")
                  if not p.name.startswith("test_"))


def _imported(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_module_the_benchmark_runs_loads_jax_or_the_jax_package():
    names = [".".join(p.relative_to(bench.ROOT).with_suffix("").parts)
             .replace(".__init__", "")
             for p in _modules()
             if p.parent.name != "metrics" and p.name != "__main__.py"]
    code = (
        "import importlib, sys\n"
        f"for m in {names!r}:\n"
        "    importlib.import_module(m)\n"
        "from pftbench import bench, testing\n"
        "for m in bench.spec()['end_to_end'] + bench.spec()['per_layer']:\n"
        "    bench._module(bench.HERE / 'metrics' / (m['name'] + '.py'))\n"
        "testing.run(testing.cell(testing.HYBRID))\n"
        "print(bench.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=bench.ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={"PYTHONPATH": f"{bench.ROOT / 'src'}",
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
    for p in _modules():
        for m in _imported(p):
            assert m.split(".")[0] not in bench.FORBIDDEN, (p, m)


def test_the_guard_compares_top_level_names_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert not {"repro_torch_like", "jaxtyping"} & set(
        bench.forbidden_modules())
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert "repro.core" in bench.forbidden_modules()


def test_the_references_import_nothing_of_the_program():
    for p in (HERE / "reference").glob("*.py"):
        for m in _imported(p):
            assert m.split(".")[0] in ("__future__", "math", "typing",
                                       "numpy", "torch"), (p, m)


def test_every_cell_finds_its_pieces():
    spec = bench.spec()
    assert spec["command"][1] == "pftbench/run.py"
    names = [c["name"] for c in spec["configs"]] \
        + [w["name"] for w in spec["workloads"]] \
        + [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
    for conf in spec["configs"]:
        data = json.loads((bench.ROOT / conf["file"]).read_text())
        assert data["reduced"] == conf["reduced"]
    for w in spec["workloads"]:
        cell = bench.cell(w["name"], spec)
        assert (HERE / "workloads" / f"{cell['mix']['kind']}.py").is_file()
        e2e = [m["name"] for m in bench.metrics_of(w["name"], spec, False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert bench.metrics_of(w["name"], spec, True)


@pytest.mark.parametrize("model", ["hubert-xlarge", "zamba2-7b"])
def test_a_configuration_runs_the_programs_own_sizes(model):
    """A configuration file's ``model`` group is the program's configuration
    of that name, field for field."""
    data = json.loads((HERE / "configs" / f"{model}.json").read_text())
    from repro_torch.configs import get_config
    cfg = get_config(model)
    for k, v in data["model"].items():
        assert getattr(cfg, k) == v, k
