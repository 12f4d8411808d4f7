"""Generator-stream discipline: the dataflow pass behind KEY-REUSE /
KEY-CHAIN / KEY-SHARD (port of ``repro/analysis/keyflow.py``).

The reference tracks JAX keys, which are values: a key consumed twice is
a bug.  A ``torch.Generator`` is a stateful stream: drawing from one
generator again and again is the ordinary idiom, each draw starting where
the last ended.  What repeats a stream is *state* that repeats, so the
three bug classes that shipped in this repo (their JAX forms are in
``tests/fixtures/lint/pr1_*``, ``pr2_*``, ``pr4_*``) take these forms:

* **KEY-REUSE** (error) — one stream consumed twice:
  two generators seeded from the same value expression in one function,
  both drawn from (the PR 2 form: k-means' choice and jitter each from a
  generator seeded ``seed``); a ``set_state`` of an earlier
  ``get_state()`` whose stream was drawn since, followed by a draw; and
  ``manual_seed(x)`` with ``x`` loop-invariant inside a loop body that
  draws (every iteration replays one stream).
* **KEY-CHAIN** (warn) — the PR 1 serial chain: a generator reseeded,
  inside a loop, from its own draw.  The draws then depend on iteration
  order and count; the order-independent form is a per-slot seed derived
  from a stable id (``fl.api.round_generator``, DESIGN.md §2).
* **KEY-SHARD** (error) — the PR 4 seed collision: a generator built in
  per-rank code (a function that reads ``get_rank`` / ``get_local_rank``
  / a mesh coordinate, one in ``core/distributed.py``, or one that calls
  such a function) from seeds with no dependence on the rank: every rank
  draws the same stream.

Model: a generator is made by ``torch.Generator(...)`` (its seed: the
``manual_seed`` argument, or the default one), by ``torch.manual_seed``
(the default generator) or by a ``*generator(...)`` helper (its seed: the
helper's arguments).  A draw is any call that passes it as
``generator=`` or positionally (the callee owns it), or a sampler
without ``generator=`` after ``torch.manual_seed``.  Two seeds are alike
when their expressions read the same and none of their names was
rebound in between.  The pass is intraprocedural; branches are walked
apart and merged (a conflict needs one path), loop bodies once.
"""
from __future__ import annotations

import ast
import copy
import dataclasses
import itertools
import os
import re
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.core import (Finding, Rule, Severity, SourceFile,
                                       dotted, walk_functions)

_DEFAULT = "<default>"
_SEEDERS = {"torch.manual_seed", "torch.cuda.manual_seed",
            "torch.cuda.manual_seed_all", "torch.random.manual_seed"}
_SAMPLERS = {"randn", "rand", "randint", "randperm", "normal", "multinomial",
             "bernoulli", "poisson", "randn_like", "rand_like",
             "randint_like"}
_INPLACE = {"normal_", "uniform_", "exponential_", "random_", "bernoulli_",
            "cauchy_", "log_normal_", "geometric_"}
_RANK_CALLS = re.compile(r"(^|\.)(get_rank|get_local_rank|get_coordinate|"
                         r"get_group_rank|axis_index)$")
_RANK_NAMES = {"rank", "local_rank", "shard", "rank_id"}
_ids = itertools.count()


def _helper(name: str) -> bool:
    """A helper that builds a seeded generator from its arguments
    (``fl.api.round_generator``); not the device's default generator."""
    base = name.rsplit(".", 1)[-1]
    return base.endswith("_generator") and "default" not in base


@dataclasses.dataclass
class Gen:
    """One generator state lineage: made (or reseeded) at ``line`` from
    ``seed`` (expression text + the versions of its names)."""
    seed: Tuple
    seed_text: str
    line: int
    uid: int = dataclasses.field(default_factory=lambda: next(_ids))
    draws: int = 0
    replayed: Optional[int] = None        # line of a set_state(replay)


def _names(node: Optional[ast.AST]) -> Set[str]:
    if node is None:
        return set()
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _calls_in_order(node: ast.AST):
    """Calls in ``node`` in evaluation order (receivers and arguments
    before the call), not descending into lambdas or nested defs."""
    if isinstance(node, (ast.Lambda, ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
        return
    if isinstance(node, ast.Call):
        yield from _calls_in_order(node.func)
        for a in node.args:
            yield from _calls_in_order(a)
        for k in node.keywords:
            yield from _calls_in_order(k.value)
        yield node
        return
    for child in ast.iter_child_nodes(node):
        yield from _calls_in_order(child)


class _State:
    def __init__(self):
        self.version: Dict[str, int] = {}
        self.gens: Dict[str, Gen] = {}
        self.drawn_seeds: Dict[Tuple, Gen] = {}
        self.snaps: Dict[str, Tuple[int, int]] = {}    # name → (uid, draws)
        self.derived: Dict[str, Set[str]] = {}         # name → gen vars

    def copy(self) -> "_State":
        return copy.deepcopy(self)


class _Flow:
    """Path-approximate walk of one function body."""

    def __init__(self, rule: Rule, src: SourceFile):
        self.rule = rule
        self.src = src
        self.s = _State()
        self.findings: List[Finding] = []
        self._seen: Set[Tuple[str, int]] = set()
        self.loops: List[dict] = []
        self.by_uid: Dict[int, Gen] = {}

    def emit(self, rule_id: str, line: int, message: str, hint: str,
             severity: Severity):
        if (rule_id, line) in self._seen:
            return
        self._seen.add((rule_id, line))
        self.findings.append(self.rule.finding(
            self.src, line, message, hint=hint, severity=severity,
            rule=rule_id))

    # -- generators ------------------------------------------------------
    def seed_key(self, expr: Optional[ast.AST], text: str) -> Tuple:
        names = sorted(_names(expr))
        return (text,) + tuple((n, self.s.version.get(n, 0)) for n in names)

    def make(self, expr: Optional[ast.AST], text: str, line: int) -> Gen:
        g = Gen(self.seed_key(expr, text), text, line)
        self.by_uid[g.uid] = g
        if self.loops:
            self.loops[-1]["seeded"].append((g, _names(expr), line))
        return g

    def creation(self, call: ast.Call) -> Optional[Gen]:
        """The generator ``call`` makes or reseeds (None: not one)."""
        name = dotted(call.func)
        if name in _SEEDERS:
            arg = call.args[0] if call.args else None
            g = self.make(arg, ast.unparse(arg) if arg else "", call.lineno)
            self.chain_check(_DEFAULT, arg, call)
            self.s.gens[_DEFAULT] = g
            return g
        if name in ("torch.Generator", "Generator"):
            return self.make(None, "<unseeded>", call.lineno)
        if isinstance(call.func, ast.Attribute) and \
                call.func.attr == "manual_seed":
            arg = call.args[0] if call.args else None
            g = self.make(arg, ast.unparse(arg) if arg else "", call.lineno)
            recv = call.func.value
            if isinstance(recv, ast.Name):
                self.chain_check(recv.id, arg, call)
                self.s.gens[recv.id] = g
            return g
        if _helper(name) and call.args:
            args = ast.Tuple(elts=list(call.args), ctx=ast.Load())
            text = ", ".join(ast.unparse(a) for a in call.args)
            return self.make(args, f"{name}({text})", call.lineno)
        return None

    def chain_check(self, var: str, seed: Optional[ast.AST], call: ast.AST):
        """KEY-CHAIN: ``var`` reseeded inside a loop from its own draw."""
        if not self.loops or seed is None:
            return
        own = any(var in self.s.derived.get(n, ()) for n in _names(seed))
        own = own or any(self.drawn_var(c) == var
                         for c in _calls_in_order(seed))
        if own:
            self.emit("KEY-CHAIN", call.lineno,
                      f"generator '{var}' is reseeded inside a loop from its "
                      f"own draw — the draws depend on iteration order and "
                      f"count (the PR 1 serial chain)",
                      "seed each iteration's generator from a stable id "
                      "(fl.api.round_generator(seed, index))",
                      Severity.WARN)

    def drawn_var(self, call: ast.Call) -> Optional[str]:
        """The generator variable ``call`` draws from, if a name."""
        for k in call.keywords:
            if k.arg == "generator" and isinstance(k.value, ast.Name):
                return k.value.id
        return None

    def known(self, var: str) -> Gen:
        """``var``'s generator; one made elsewhere (a parameter, an
        attribute) is a lineage of its own."""
        if var not in self.s.gens:
            g = Gen(("<given>", var, next(_ids)), var, 0)
            self.by_uid[g.uid] = g
            self.s.gens[var] = g
        return self.s.gens[var]

    def draw(self, var: str, line: int):
        if var == _DEFAULT and var not in self.s.gens:
            return
        g = self.known(var)
        if g.replayed is not None:
            self.emit("KEY-REUSE", line,
                      f"generator '{var}' draws after set_state (line "
                      f"{g.replayed}) restored a state already consumed — "
                      f"the stream replays",
                      "draw from a fresh generator with a derived seed "
                      "(state.reset() of the sanitizer marks deliberate "
                      "replays)", Severity.ERROR)
        if g.draws == 0:
            other = self.s.drawn_seeds.get(g.seed)
            if other is not None and other.uid != g.uid:
                self.emit("KEY-REUSE", g.line,
                          f"generator '{var}' seeded from "
                          f"'{g.seed_text}' and drawn at line {line} "
                          f"replays the stream of the generator seeded "
                          f"alike at line {other.line}, already drawn from",
                          "derive a distinct seed per stream (or draw both "
                          "from one generator)", Severity.ERROR)
            self.s.drawn_seeds.setdefault(g.seed, g)
        g.draws += 1

    # -- expressions ------------------------------------------------------
    def eval(self, node: Optional[ast.AST]) -> Tuple[Optional[Gen],
                                                      Set[str]]:
        """Process the calls of ``node``: (the generator it evaluates to,
        the generator variables it drew from)."""
        if node is None:
            return None, set()
        made: Dict[int, Gen] = {}
        drew: Set[str] = set()
        for call in _calls_in_order(node):
            g = self.creation(call)
            if g is not None:
                made[id(call)] = g
            fname = dotted(call.func)
            attr = call.func.attr if isinstance(call.func, ast.Attribute) \
                else ""
            if attr in ("get_state", "set_state", "manual_seed", "seed",
                        "initial_seed", "get_offset", "set_offset"):
                if attr == "set_state" and isinstance(call.func.value,
                                                      ast.Name):
                    self.restore(call.func.value.id, call)
                continue
            has_gen_kw = False
            for k in call.keywords:
                if k.arg == "generator":
                    has_gen_kw = True
                    if isinstance(k.value, ast.Name):
                        self.draw(k.value.id, call.lineno)
                        drew.add(k.value.id)
                    elif isinstance(k.value, ast.Call) and \
                            id(k.value) in made:
                        self.tmp_draw(made[id(k.value)], call.lineno)
            for a in call.args:
                if isinstance(a, ast.Name) and a.id in self.s.gens \
                        and a.id != _DEFAULT:
                    self.draw(a.id, call.lineno)
                    drew.add(a.id)
            base = fname.rsplit(".", 1)[-1]
            if not has_gen_kw and _DEFAULT in self.s.gens and (
                    (fname.startswith("torch.") and base in _SAMPLERS)
                    or attr in _INPLACE):
                self.draw(_DEFAULT, call.lineno)
                drew.add(_DEFAULT)
        gen = made.get(id(node)) if isinstance(node, ast.Call) else None
        if isinstance(node, ast.Name) and node.id in self.s.gens:
            gen = self.s.gens[node.id]
        return gen, drew

    def tmp_draw(self, g: Gen, line: int):
        self.s.gens["<inline>"] = g
        self.draw("<inline>", line)
        del self.s.gens["<inline>"]

    def restore(self, var: str, call: ast.Call):
        arg = call.args[0] if call.args else None
        g = self.s.gens.get(var)
        if isinstance(arg, ast.Name) and arg.id in self.s.snaps:
            uid, draws = self.s.snaps[arg.id]
            src = self.by_uid.get(uid)
            if src is not None and src.draws > draws:
                new = Gen(src.seed, src.seed_text, call.lineno)
                new.replayed = call.lineno
                new.draws = 1
                self.by_uid[new.uid] = new
                self.s.gens[var] = new
                return
        if g is not None:     # restored to some other state: a new lineage
            new = Gen(("<set_state>", call.lineno, next(_ids)), "<state>",
                      call.lineno)
            self.by_uid[new.uid] = new
            self.s.gens[var] = new

    # -- statements -------------------------------------------------------
    def bind(self, target: ast.AST, gen: Optional[Gen], drew: Set[str],
             value: Optional[ast.AST]):
        for n in ast.walk(target):
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store):
                self.s.version[n.id] = self.s.version.get(n.id, 0) + 1
                self.s.snaps.pop(n.id, None)
                src = set(drew)
                for m in _names(value):
                    src |= self.s.derived.get(m, set())
                if src:
                    self.s.derived[n.id] = src
                else:
                    self.s.derived.pop(n.id, None)
                if isinstance(target, ast.Name) and gen is not None:
                    self.s.gens[n.id] = gen
                elif n.id in self.s.gens and gen is None:
                    del self.s.gens[n.id]
        if isinstance(target, ast.Name) and isinstance(value, ast.Call) \
                and isinstance(value.func, ast.Attribute) \
                and value.func.attr == "get_state" \
                and isinstance(value.func.value, ast.Name):
            g = self.known(value.func.value.id)
            self.s.snaps[target.id] = (g.uid, g.draws)

    def run_stmts(self, body):
        for stmt in body:
            self.run_stmt(stmt)

    def run_stmt(self, stmt: ast.stmt):
        if isinstance(stmt, ast.Assign):
            gen, drew = self.eval(stmt.value)
            for t in stmt.targets:
                if gen is not None and isinstance(t, ast.Name):
                    self.chain_check(t.id, stmt.value, stmt)
                self.bind(t, gen, drew, stmt.value)
        elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
            gen, drew = self.eval(stmt.value)
            self.bind(stmt.target, gen if isinstance(stmt, ast.AnnAssign)
                      else None, drew, stmt.value)
        elif isinstance(stmt, (ast.Expr, ast.Return)):
            self.eval(stmt.value)
        elif isinstance(stmt, ast.If):
            self.eval(stmt.test)
            self.branches([stmt.body, stmt.orelse])
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            _, drew = self.eval(stmt.iter)
            self.loop(stmt, stmt.target, drew, stmt.iter)
            self.run_stmts(stmt.orelse)
        elif isinstance(stmt, ast.While):
            self.eval(stmt.test)
            self.loop(stmt, None, set(), None)
            self.run_stmts(stmt.orelse)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                gen, drew = self.eval(item.context_expr)
                if item.optional_vars is not None:
                    self.bind(item.optional_vars, gen, drew,
                              item.context_expr)
            self.run_stmts(stmt.body)
        elif isinstance(stmt, ast.Try):
            self.run_stmts(stmt.body)
            self.branches([[]] + [h.body for h in stmt.handlers])
            self.run_stmts(stmt.orelse)
            self.run_stmts(stmt.finalbody)
        elif isinstance(stmt, (ast.Raise, ast.Assert, ast.Delete)):
            for child in ast.iter_child_nodes(stmt):
                if isinstance(child, ast.expr):
                    self.eval(child)

    def branches(self, bodies):
        base = self.s
        outs = []
        for body in bodies:
            self.s = base.copy()
            self.run_stmts(body)
            if not (body and isinstance(body[-1], (ast.Return, ast.Raise,
                                                   ast.Continue,
                                                   ast.Break))):
                outs.append(self.s)
        if not outs:
            self.s = base
            return
        merged = outs[0]
        for other in outs[1:]:
            for n, v in other.version.items():
                merged.version[n] = max(v, merged.version.get(n, 0))
            merged.gens.update({k: v for k, v in other.gens.items()
                                if k not in merged.gens})
            for k, v in other.derived.items():
                merged.derived[k] = merged.derived.get(k, set()) | v
        self.s = merged
        # copies broke the identity between a state's Gens and by_uid
        for g in self.s.gens.values():
            self.by_uid[g.uid] = g

    def loop(self, node, target, drew, iter_expr):
        bound = set()
        for n in ast.walk(node):
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store):
                bound.add(n.id)
        frame = {"seeded": [], "bound": bound}
        self.loops.append(frame)
        if target is not None:
            self.bind(target, None, drew, iter_expr)
        self.run_stmts(node.body)
        self.loops.pop()
        for g, names, line in frame["seeded"]:
            live = self.by_uid.get(g.uid, g)
            if live.draws > 0 and not (names & bound) and \
                    g.seed_text != "<unseeded>":
                self.emit("KEY-REUSE", line,
                          f"generator seeded from loop-invariant "
                          f"'{g.seed_text}' inside a loop that draws from "
                          f"it — every iteration replays one stream",
                          "seed from the iteration's stable id (seed, "
                          "index), or make the generator once before the "
                          "loop", Severity.ERROR)

    def run_function(self, fn):
        self.run_stmts(fn.body)


class KeyDisciplineRule(Rule):
    id = "KEY-REUSE"          # also emits KEY-CHAIN
    severity = Severity.ERROR
    doc = ("one generator stream consumed twice — generators seeded alike, "
           "a restored get_state, a loop-invariant manual_seed in a drawing "
           "loop (KEY-REUSE, error); a generator reseeded from its own draw "
           "in a loop (KEY-CHAIN, warn)")
    reference = "KEY-REUSE / KEY-CHAIN"
    hazard = "identical 'independent' draws; draws that depend on loop order"

    def run(self, src: SourceFile):
        findings: List[Finding] = []
        mod = _Flow(self, src)
        mod.run_stmts([s for s in src.tree.body
                       if not isinstance(s, (ast.FunctionDef,
                                             ast.AsyncFunctionDef,
                                             ast.ClassDef))])
        findings.extend(mod.findings)
        for fn in walk_functions(src.tree):
            an = _Flow(self, src)
            an.run_function(fn)
            findings.extend(an.findings)
        return findings


class ShardSeedRule(Rule):
    id = "KEY-SHARD"
    severity = Severity.ERROR
    doc = ("a generator built in per-rank code (reads get_rank / "
           "get_local_rank / a mesh coordinate, or core/distributed.py) "
           "from seeds with no rank dependence — every rank draws the same "
           "stream (the PR 4 collision)")
    reference = "KEY-SHARD"
    hazard = "'independent' clients on different ranks share one stream"

    def run(self, src: SourceFile):
        norm = src.path.replace(os.sep, "/")
        in_dist = norm.endswith("repro_torch/core/distributed.py")
        defs = {fn.name: fn for fn in walk_functions(src.tree)}
        dist_aliases = set()
        for node in ast.walk(src.tree):
            if isinstance(node, ast.ImportFrom) and node.module in (
                    "repro_torch.core",) and node.names:
                dist_aliases |= {a.asname or a.name for a in node.names
                                 if a.name == "distributed"}
            if isinstance(node, ast.Import):
                dist_aliases |= {a.asname for a in node.names
                                 if a.name == "repro_torch.core.distributed"
                                 and a.asname}
        per_rank = {name for name, fn in defs.items()
                    if in_dist or self._reads_rank(fn)}
        changed = True
        while changed:
            changed = False
            for name, fn in defs.items():
                if name in per_rank:
                    continue
                for call in ast.walk(fn):
                    if not isinstance(call, ast.Call):
                        continue
                    f = call.func
                    if (isinstance(f, ast.Name) and f.id in per_rank) or (
                            isinstance(f, ast.Attribute)
                            and isinstance(f.value, ast.Name)
                            and f.value.id in dist_aliases):
                        per_rank.add(name)
                        changed = True
                        break
        findings = []
        for name in sorted(per_rank):
            findings.extend(self._check(src, defs[name]))
        return findings

    @staticmethod
    def _reads_rank(fn) -> bool:
        return any(isinstance(n, ast.Call) and _RANK_CALLS.search(
            dotted(n.func)) for n in ast.walk(fn))

    def _check(self, src: SourceFile, fn):
        tainted: Set[str] = {a.arg for a in fn.args.posonlyargs
                             + fn.args.args + fn.args.kwonlyargs
                             if a.arg in _RANK_NAMES}
        binds = []
        for s in ast.walk(fn):
            if isinstance(s, ast.Assign):
                binds += [(t, s.value) for t in s.targets]
            elif isinstance(s, (ast.For, ast.comprehension)):
                binds.append((s.target, s.iter))
            elif isinstance(s, (ast.AnnAssign, ast.AugAssign)) and s.value:
                binds.append((s.target, s.value))
        changed = True
        while changed:
            changed = False
            for target, value in binds:
                if self._tainted(value, tainted):
                    for n in ast.walk(target):
                        if isinstance(n, ast.Name) and n.id not in tainted:
                            tainted.add(n.id)
                            changed = True
        findings = []
        for call in ast.walk(fn):
            if not isinstance(call, ast.Call):
                continue
            name = dotted(call.func)
            is_seed = name in _SEEDERS or (
                isinstance(call.func, ast.Attribute)
                and call.func.attr == "manual_seed") or (
                _helper(name) and bool(call.args))
            if not is_seed:
                continue
            args = list(call.args) + [k.value for k in call.keywords]
            if any(self._tainted(a, tainted) for a in args):
                continue
            findings.append(self.finding(
                src, call.lineno,
                f"generator seeded in per-rank '{fn.name}' from "
                f"'{ast.unparse(call)}', which does not depend on the rank "
                f"— every rank draws the same stream",
                "offset the seed by the rank's client ids "
                "(core/distributed.py client_seeds)"))
        return findings

    @staticmethod
    def _tainted(expr: ast.AST, tainted: Set[str]) -> bool:
        for n in ast.walk(expr):
            if isinstance(n, ast.Call) and _RANK_CALLS.search(dotted(n.func)):
                return True
            if isinstance(n, ast.Name) and n.id in tainted:
                return True
        return False
