"""The port's ``repro_torch.analysis`` lint engine and rules.

* **Engine parity** with ``repro.analysis`` on the same files:
  ``Finding.format``, suppression parsing, ``summarize``,
  ``iter_python_files``, the CLI's exit codes, and EXC-SWALLOW's (rule,
  line) on ``tests/fixtures/lint/exc_swallow_*.py``.
* **Twins**: each port rule fires exactly on its bad twin and stays
  silent on its good twin, including the torch forms of the PR 1 serial
  chain, the PR 2 same-stream k-means draws and the PR 4 cross-rank seed
  collision (the JAX forms live in ``tests/fixtures/lint/``).
* **Grid parity**: CHURN-RETRACE's cases (names and floating shapes)
  are the reference's.
* **Wire mutations**, the pure **launch checks** on hand-made plans, and
  the **self-clean** gate on the port's tree (``--device cpu``).
"""
import pathlib
import textwrap
import types

import pytest
import torch

from repro.analysis import __main__ as ref_cli
from repro.analysis import core as ref_core
from repro.analysis import hygiene as ref_hygiene
from repro_torch.analysis import __main__ as cli
from repro_torch.analysis import compile as C
from repro_torch.analysis import core
from repro_torch.analysis import hygiene, pallas_rules, wire
from repro_torch.kernels import _build

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXDIR = ROOT / "tests" / "fixtures" / "lint"


def _write(root: pathlib.Path, rel: str, text: str) -> pathlib.Path:
    p = root / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(text))
    return p


def _ast(paths, rules=None):
    return core.analyze_paths([str(p) for p in paths], rules=rules,
                              semantic=False)


# ---------------------------------------------------------------------------
# engine parity
# ---------------------------------------------------------------------------


class TestEngineParity:
    def test_finding_format_and_gates(self):
        for sev in ("INFO", "WARN", "ERROR"):
            for sup in (False, True):
                for hint in ("", "do this"):
                    kw = dict(rule="KEY-REUSE", path="a/b.py", line=7,
                              message="m", hint=hint, suppressed=sup)
                    a = core.Finding(severity=core.Severity[sev], **kw)
                    b = ref_core.Finding(severity=ref_core.Severity[sev],
                                         **kw)
                    assert a.format() == b.format()
                    assert a.gates == b.gates

    def test_suppression_parsing(self, tmp_path):
        p = _write(tmp_path, "s.py", """\
            x = 1  # lint: disable=KEY-REUSE
            y = 2  #lint:disable=HOST-SYNC, CHURN-STATIC
            z = 3  # lint: disable=*
            w = 4  # lint disable=KEY-REUSE
            """)
        files = [p] + sorted(FIXDIR.glob("*.py"))
        for f in files:
            a, b = core.SourceFile.load(str(f)), ref_core.SourceFile.load(
                str(f))
            assert a.suppressions == b.suppressions
            for line in range(1, 6):
                for rule in ("KEY-REUSE", "HOST-SYNC", "X"):
                    assert a.is_suppressed(rule, line) == \
                        b.is_suppressed(rule, line)

    def test_summarize(self):
        fs = [("ERROR", False), ("ERROR", True), ("WARN", False),
              ("INFO", False), ("INFO", True)]
        a = [core.Finding("R", core.Severity[s], "p", 1, "m", suppressed=u)
             for s, u in fs]
        b = [ref_core.Finding("R", ref_core.Severity[s], "p", 1, "m",
                              suppressed=u) for s, u in fs]
        assert core.summarize(a) == ref_core.summarize(b)
        assert len(core.gating(a)) == len(ref_core.gating(b)) == 2

    def test_iter_python_files(self, tmp_path):
        _write(tmp_path, "a/x.py", "")
        _write(tmp_path, "a/__pycache__/y.py", "")
        _write(tmp_path, "a/b/z.py", "")
        _write(tmp_path, "a/b/n.txt", "")
        paths = [str(tmp_path / "a"), str(tmp_path / "a" / "x.py"),
                 str(FIXDIR)]
        assert core.iter_python_files(paths) == \
            ref_core.iter_python_files(paths)

    @pytest.mark.parametrize("body,rc", [
        ("def f():\n    try:\n        g()\n    except:\n        pass\n", 1),
        ("def f():\n    try:\n        g()\n    except ValueError:\n"
         "        raise\n", 0),
        ("def f(:\n", 1),
        ("def f():\n    try:\n        g()\n    except:"
         "  # lint: disable=EXC-SWALLOW\n        pass\n", 0),
    ])
    def test_cli_exit_codes(self, tmp_path, body, rc):
        ref = _write(tmp_path, "src/repro/fl/x.py", body)
        port = _write(tmp_path, "src/repro_torch/fl/x.py", body)
        assert ref_cli.main(["--no-semantic", str(ref)]) == rc
        assert cli.main(["--no-semantic", str(port)]) == rc

    def test_exc_swallow_matches_the_reference(self):
        for name, n in (("exc_swallow_bad.py", 4), ("exc_swallow_good.py",
                                                    0)):
            got = [(f.rule, f.line) for f in hygiene.ExcSwallowRule(
                restrict=()).run(core.SourceFile.load(str(FIXDIR / name)))]
            want = [(f.rule, f.line) for f in ref_hygiene.ExcSwallowRule(
                restrict=()).run(ref_core.SourceFile.load(
                    str(FIXDIR / name)))]
            assert got == want and len(got) == n
        # path gate: silent outside fl/ and serve/
        src = core.SourceFile.load(str(FIXDIR / "exc_swallow_bad.py"))
        src.path = "src/repro_torch/core/exc_swallow_bad.py"
        assert list(hygiene.ExcSwallowRule().run(src)) == []
        src.path = "src/repro_torch/serve/exc_swallow_bad.py"
        assert len(list(hygiene.ExcSwallowRule().run(src))) == 4

    def test_list_rules_covers_every_reference_rule(self, capsys):
        assert cli.main(["--list-rules"]) == 0
        table = capsys.readouterr().out
        port = core._default_rules()
        for ref_rule in ref_core._default_rules():
            owners = [r for r in port if ref_rule.id in r.reference]
            assert owners, ref_rule.id
            assert owners[0].id in table

    def test_semantic_rules_refuse_a_missing_card(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present")
        with pytest.raises(RuntimeError, match="--device cpu"):
            core.analyze_paths([str(ROOT / "src/repro_torch/fl/api.py")])
        with pytest.raises(RuntimeError, match="--device cpu"):
            cli.main([str(ROOT / "src/repro_torch/fl/api.py")])


# ---------------------------------------------------------------------------
# bad / good twins of every AST rule
# ---------------------------------------------------------------------------

TWINS = {
    # PR 2, torch form: choice and jitter each from a generator seeded
    # `seed` — one stream drawn twice
    "pr2_kmeans": ("KEY-REUSE", "m.py", """\
        import torch


        def kmeans_init(x, weights, K, seed):
            p = weights / weights.sum().clamp_min(1e-12)
            g_idx = torch.Generator().manual_seed(seed)
            idx = torch.multinomial(p, K, replacement=True, generator=g_idx)
            g_jit = torch.Generator().manual_seed(seed)
            mu = x[idx]
            return mu + 1e-3 * torch.randn(mu.shape, generator=g_jit)
        """, """\
        import torch


        def kmeans_init(x, weights, K, seed):
            p = weights / weights.sum().clamp_min(1e-12)
            g = torch.Generator().manual_seed(seed)
            idx = torch.multinomial(p, K, replacement=True, generator=g)
            mu = x[idx]
            return mu + 1e-3 * torch.randn(mu.shape, generator=g)
        """),
    "restored_state": ("KEY-REUSE", "m.py", """\
        import torch


        def twice(g, n):
            saved = g.get_state()
            a = torch.randn(n, generator=g)
            g.set_state(saved)
            b = torch.randn(n, generator=g)
            return a + b
        """, """\
        import torch


        def twice(g, n):
            saved = g.get_state()
            a = torch.randn(n, generator=g)
            b = torch.randn(n, generator=g)
            g.set_state(saved)
            return a + b
        """),
    "loop_invariant_seed": ("KEY-REUSE", "m.py", """\
        import torch


        def per_class(counts, d, seed):
            g = torch.Generator()
            out = []
            for c, n in enumerate(counts):
                g.manual_seed(seed)
                out.append(torch.randn(n, d, generator=g))
            return out
        """, """\
        import torch


        def per_class(counts, d, seed):
            g = torch.Generator()
            out = []
            for c, n in enumerate(counts):
                g.manual_seed(seed * 1000 + c)
                out.append(torch.randn(n, d, generator=g))
            return out
        """),
    # PR 1, torch form: each message's generator is seeded from a draw of
    # the previous one — a serial chain
    "pr1_synthesis": ("KEY-CHAIN", "m.py", """\
        import torch


        def synthesize(generator, messages, cov_type):
            g = generator
            feats = []
            for msg in messages:
                seed = int(torch.randint(0, 2 ** 62, (1,), generator=g))
                g = torch.Generator().manual_seed(seed)
                feats.append(sample(msg, cov_type, generator=g))
            return feats
        """, """\
        import torch


        def synthesize(seed, messages, cov_type):
            feats = []
            for i, msg in enumerate(messages):
                g = round_generator(seed, 1 + i, "cpu")
                feats.append(sample(msg, cov_type, generator=g))
            return feats
        """),
    # PR 4, torch form: per-client generators seeded with no rank offset
    # in per-rank code — every rank draws the same streams
    "pr4_shard_seeds": ("KEY-SHARD", "m.py", """\
        import torch
        import torch.distributed as dist


        def fedpft_transfer(feats, labels, cfg, seed=0):
            rank = dist.get_rank()
            I_local = feats.shape[0] // dist.get_world_size()
            own = feats[rank * I_local:(rank + 1) * I_local]
            gens = [torch.Generator().manual_seed(seed + i)
                    for i in range(I_local)]
            return [fit_client(g, f, cfg) for g, f in zip(gens, own)]
        """, """\
        import torch
        import torch.distributed as dist


        def fedpft_transfer(feats, labels, cfg, seed=0):
            rank = dist.get_rank()
            I_local = feats.shape[0] // dist.get_world_size()
            own = feats[rank * I_local:(rank + 1) * I_local]
            gens = [torch.Generator().manual_seed(seed + rank * I_local + i)
                    for i in range(I_local)]
            return [fit_client(g, f, cfg) for g, f in zip(gens, own)]
        """),
    "host_sync_step_loop": ("HOST-SYNC", "src/repro_torch/core/m.py", """\
        def train(params, opt, batches, n_steps):
            losses = []
            for step in range(n_steps):
                loss = opt.step(params, batches[step])
                losses.append(loss.item())
            return losses
        """, """\
        def train(params, opt, batches, n_steps):
            losses = []
            for step in range(n_steps):
                losses.append(opt.step(params, batches[step]))
            return [float(x) for x in losses]
        """),
    "inline_capture": ("CHURN-INLINE-BUILD", "m.py", """\
        import torch


        def replay_all(fn, inputs):
            outs = []
            for x in inputs:
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g):
                    y = fn(x)
                g.replay()
                outs.append(y)
            return outs
        """, """\
        import torch


        def replay_all(fn, inputs, buf):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                y = fn(buf)
            outs = []
            for x in inputs:
                buf.copy_(x)
                g.replay()
                outs.append(y.clone())
            return outs
        """),
    "inline_build": ("CHURN-INLINE-BUILD", "m.py", """\
        from repro_torch.kernels import _build


        def launch_all(calls):
            for source, args in calls:
                _build.load(source).run(*args)
        """, """\
        from repro_torch.kernels import _build


        def launch_all(calls):
            libs = {s: _build.load(s) for s in {s for s, _ in calls}}
            for source, args in calls:
                libs[source].run(*args)
        """),
    "static_memo": ("CHURN-STATIC", "m.py", """\
        import functools

        import torch


        @functools.lru_cache(maxsize=None)
        def plan(shape, opts=[]):
            return shape


        @functools.lru_cache(maxsize=16)
        def scale_of(x: torch.Tensor, d: int):
            return x.shape[-1] ** -0.5
        """, """\
        import functools


        @functools.lru_cache(maxsize=None)
        def plan(shape, opts=()):
            return shape


        @functools.lru_cache(maxsize=16)
        def scale_of(shape: tuple, d: int):
            return shape[-1] ** -0.5
        """),
}


class TestTwins:
    @pytest.mark.parametrize("name", sorted(TWINS))
    def test_bad_fires_exactly_its_rule(self, tmp_path, name):
        rule, rel, bad, _ = TWINS[name]
        fs = _ast([_write(tmp_path, rel, bad)])
        assert {f.rule for f in fs} == {rule}, [f.format() for f in fs]
        assert all(f.gates for f in fs)

    @pytest.mark.parametrize("name", sorted(TWINS))
    def test_good_twin_is_clean(self, tmp_path, name):
        _, rel, _, good = TWINS[name]
        fs = _ast([_write(tmp_path, rel, good)])
        assert fs == [], [f.format() for f in fs]

    def test_host_sync_in_captured_code(self, tmp_path):
        """round_program and the core/ functions it reaches are what a
        CUDA graph capture records: a sync there is flagged; the same
        function outside the captured closure is not."""
        head = """\
            def fused_steps(x, n):
                return helper(x) * n


            def helper(x):
                return x * {sync}


            def host_side(x):
                return float(x.sum())
            """
        rnd = """\
            from repro_torch.core import head as H


            def round_program(pi, mu, sig):
                return H.fused_steps(mu, sig.M)


            def pad_cohort(msgs):
                return [m.counts.item() for m in msgs]
            """
        for sync, want in (("float(x.max())", {6}), ("2.0", set())):
            root = tmp_path / sync.replace("(", "_").replace(")", "_")
            _write(root, "repro_torch/fl/round.py", rnd)
            p = _write(root, "repro_torch/core/head.py",
                       head.format(sync=sync))
            fs = _ast([p], [hygiene.HostSyncRule()])
            assert {f.line for f in fs} == want, [f.format() for f in fs]
            assert all(f.rule == "HOST-SYNC" for f in fs)

    def test_ordinary_stateful_idiom_is_clean(self, tmp_path):
        p = _write(tmp_path, "m.py", """\
            import torch


            def draws(seed, n, steps):
                g = torch.Generator().manual_seed(seed)
                out = [torch.randn(n, generator=g) for _ in range(steps)]
                for s in range(steps):
                    out.append(torch.rand(n, generator=g))
                    out.append(torch.empty(n).normal_(generator=g))
                return out
            """)
        assert _ast([p]) == []

    def test_suppression_with_reason_does_not_gate(self, tmp_path):
        _, rel, bad, _ = TWINS["pr2_kmeans"]
        bad = bad.replace("g_jit = torch.Generator().manual_seed(seed)",
                          "g_jit = torch.Generator().manual_seed(seed)"
                          "  # lint: disable=KEY-REUSE")
        fs = _ast([_write(tmp_path, rel, bad)])
        assert fs and not core.gating(fs)


# ---------------------------------------------------------------------------
# CHURN-RETRACE grid parity, CACHE-KEY
# ---------------------------------------------------------------------------


def _float_shapes(tree, is_float):
    import jax
    leaves = jax.tree_util.tree_leaves(tree, is_leaf=lambda x: x is None)
    return sorted(tuple(int(s) for s in x.shape) for x in leaves
                  if x is not None and is_float(x))


def test_retrace_grid_is_the_references():
    import jax.numpy as jnp

    from repro.analysis import compile as RC
    port, ref = C.entry_points(), RC.entry_points()
    assert len(port) == len(ref) == 7
    pairs = {"gmm_estep_fused": "estep_fused",
             "attention": "flash_attention", "train_head": "train_head",
             "fit_gmm_batch": "_fit_gmm_batch", "local_train": "local_train",
             "_sample_stacked": "_sample_stacked",
             "round_program": "round_program"}
    for pe, re_ in zip(port, ref):
        assert pairs[pe.name.rsplit(".", 1)[-1]] == \
            re_.name.rsplit(".", 1)[-1]
        pc, rc = pe.cases(), re_.cases()
        assert [c for c, _, _ in pc] == [c for c, _, _ in rc]
        for (case, pa, _), (_, ra, _) in zip(pc, rc):
            got = _float_shapes(
                list(pa), lambda x: torch.is_tensor(x)
                and x.is_floating_point())
            want = _float_shapes(
                list(ra), lambda x: hasattr(x, "dtype")
                and jnp.issubdtype(x.dtype, jnp.floating))
            assert got == want, (pe.name, case)


def test_retrace_and_cache_key_hold_and_fire():
    fs = core.analyze_paths([str(ROOT / "src/repro_torch/fl/round.py"),
                             str(ROOT / "src/repro_torch/launch/"
                                 "aot_cache.py")],
                            rules=[C.CacheKeyRule()], device="cpu")
    assert fs == [], [f.format() for f in fs]
    seqs, errors = C.trace_entry(C.cache_entry_points()[0])
    assert errors == [] and len(seqs) == 4
    # an entry whose ops depend on state outside its inputs diverges
    calls = []

    def drifting(x):
        calls.append(1)
        return x * 2 if len(calls) % 2 else x + 2

    entry = C.Entry("drift", "repro_torch/fl/round.py", lambda: drifting,
                    lambda: [("c", (C._meta((4,)),), {})])
    assert C.trace_entry(entry)[1] == [("c", "RETRACE-DIVERGED")]
    bad = C.Entry("unhashable", "repro_torch/fl/round.py",
                  lambda: drifting, lambda: [], lambda: {"opts": [1]})
    fs = core.analyze_paths([str(ROOT / "src/repro_torch/fl/round.py")],
                            rules=[C.RetraceRule([entry, bad])],
                            device="cpu")
    assert sorted(f.rule for f in fs) == ["CHURN-RETRACE"] * 2


# ---------------------------------------------------------------------------
# WIRE-CONTRACT
# ---------------------------------------------------------------------------

WIRE_FILES = [str(ROOT / "src/repro_torch/fl/api.py"),
              str(ROOT / "src/repro_torch/core/gmm.py")]


def _wire(**kw):
    return core.analyze_paths(WIRE_FILES, rules=[wire.WireContractRule(
        **kw)], device="cpu")


def test_wire_contract_is_clean_on_the_port():
    assert _wire() == []


def test_wire_contract_fires_on_a_copied_field_tuple():
    from repro_torch.core import gmm as G
    from repro_torch.fl import api as FA
    api = types.SimpleNamespace(**vars(FA))
    api._GMM_FIELDS = tuple(list(G.WIRE_FIELDS))
    fs = _wire(api=api)
    assert [f.rule for f in fs] == ["WIRE-CONTRACT"]
    assert "object identity" in fs[0].message


def test_wire_contract_fires_on_a_miscounted_byte_length():
    from repro_torch.core import gmm as G
    gmm = types.SimpleNamespace(**vars(G))
    gmm.comm_bytes = lambda *a: G.comm_bytes(*a) + 2
    fs = _wire(gmm=gmm)
    assert len(fs) == 3 and all("accounting drift" in f.message for f in fs)


# ---------------------------------------------------------------------------
# the Hopper launch contract
# ---------------------------------------------------------------------------

CLEAN_PLAN = {"kernel": "k<64>", "grid": (64, 4, 1), "block": (128, 1, 1),
              "dyn_smem": 100_000, "cover": ((64, 1), (250, 64), (0, 0)),
              "route": "bf16"}
CLEAN_ATTRS = {"static_smem": 0, "regs": 168, "local_bytes": 0,
               "max_threads": 1024, "blocks_per_sm": 2, "status": 0}


@pytest.mark.parametrize("plan,attrs,want", [
    ({}, {}, []),
    ({"dyn_smem": 232_000}, {"static_smem": 1024}, [("CUDA-SMEM", 2)]),
    ({"dyn_smem": 232_448}, {}, []),
    ({}, {"blocks_per_sm": 0}, [("CUDA-OCC", 2)]),
    ({"block": (512, 1, 1)}, {"max_threads": 256}, [("CUDA-OCC", 2)]),
    ({}, {"status": 1}, [("CUDA-OCC", 2)]),
    ({"grid": (64, 70_000, 1)}, {}, [("CUDA-GRID", 2)]),
    ({"grid": (64, 3, 1)}, {}, [("CUDA-GRID", 2)]),       # 3·64 < 250
    ({"grid": (0, 4, 1)}, {}, [("CUDA-GRID", 2)] * 2),   # and 0·1 < 64
    ({}, {"local_bytes": 8}, [("CUDA-SPILL", 1)]),
    ({"route": "f32"}, {"local_bytes": 32}, [("CUDA-SPILL", 0)]),
    # the documented bf16 spills: up to their bytes, and no more
    ({"kernel": "ssd_mma_kernel<64>"}, {"local_bytes": 64},
     [("CUDA-SPILL", 0)]),
    ({"kernel": "ssd_mma_kernel<64>"}, {"local_bytes": 72},
     [("CUDA-SPILL", 1)]),
    ({"kernel": "ssd_mma_kernel<32>"}, {"local_bytes": 8},
     [("CUDA-SPILL", 1)]),
])
def test_check_launch_on_hand_made_plans(plan, attrs, want):
    got = pallas_rules.check_launch({**CLEAN_PLAN, **plan},
                                    {**CLEAN_ATTRS, **attrs})
    assert [(r, int(s)) for r, s, _ in got] == want


def test_launch_contract_says_it_was_not_checked_without_a_card():
    files = [str(ROOT / "src/repro_torch/kernels" / pathlib.Path(a).name)
             for a in pallas_rules.WRAPPERS.values()]
    fs = core.analyze_paths(files, rules=[pallas_rules.LaunchContractRule()],
                            device="cpu")
    assert len(fs) == 9 == len(pallas_rules.WRAPPERS)
    assert all(f.severity == core.Severity.INFO and "not checked"
               in f.message for f in fs)
    # every source has a probe
    assert {p.source for p in pallas_rules.kernel_probes()} == \
        set(pallas_rules.WRAPPERS) == set(_build.SOURCES)


def test_planning_counts_no_launch():
    table = {"k": 0}
    _build.count(table, "k")
    _build._PLANNING.append([])
    try:
        _build.count(table, "k")
    finally:
        _build._PLANNING.pop()
    assert table == {"k": 1}


# ---------------------------------------------------------------------------
# self-clean
# ---------------------------------------------------------------------------

PORT_PATHS = [str(ROOT / p) for p in core.DEFAULT_PATHS]


def test_port_tree_is_clean_ast():
    fs = core.analyze_paths(PORT_PATHS, semantic=False)
    assert core.gating(fs) == [], "\n".join(f.format()
                                           for f in core.gating(fs))


def test_port_tree_is_clean_semantic_on_cpu(capsys):
    assert cli.main([*PORT_PATHS, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "0 error, 0 warn" in out
