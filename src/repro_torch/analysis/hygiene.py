"""Hygiene rules: HOST-SYNC, CHURN-INLINE-BUILD, CHURN-STATIC, EXC-SWALLOW
(port of ``repro/analysis/hygiene.py``).

HOST-SYNC — a ``.item()`` / ``.tolist()`` / ``.cpu()`` / ``.numpy()`` /
``float()`` / ``int()`` / ``bool()`` of a tensor, ``np.asarray(tensor)``
or ``torch.cuda.synchronize()`` where the port's counterpart of traced
code runs.  The reference scopes the rule to jitted functions under
``fl/``, ``core/``, ``kernels/``.  The port has no tracer; two places
play its part:

* the code that ``launch/aot_cache.py::_capture`` records into a CUDA
  graph — every function of ``fl/round.py`` and the functions of
  ``core/`` it reaches — where a sync breaks the capture outright;
* the bodies of step loops in ``fl/``, ``core/``, ``kernels/``,
  ``train/`` and ``serve/`` (a ``for`` over ``range`` of a step, iteration
  or token count, a ``while`` loop), where a sync stalls the card once a
  step.

Static quantities (``.shape``, ``len()``, ``.numel()``, config and
signature fields, constants) are exempt.

CHURN-INLINE-BUILD — a CUDA graph captured (``torch.cuda.graph``,
``CUDAGraph()``, ``make_graphed_callables``) or a kernel library built
or loaded (``_build.build`` / ``_build.load``, ``ctypes.CDLL``) inside a
loop body: the port's counterpart of a ``jax.jit`` built per iteration.

CHURN-STATIC — a ``functools.lru_cache`` / ``functools.cache`` function
with a mutable-literal default (unhashable: TypeError at the first call)
or a parameter annotated with an unhashable or identity-hashed type
(``list`` / ``dict`` / ``set``, ``np.ndarray``, ``torch.Tensor``: every
call misses, and a tensor key keeps its memory alive).

EXC-SWALLOW — as the reference's: a bare ``except:`` or a broad
``except Exception: pass`` in ``fl/`` or ``serve/``.
"""
from __future__ import annotations

import ast
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.core import (Finding, Rule, Severity, SourceFile,
                                       dotted, loop_bodies)

_LOOP_DIRS = ("repro_torch/fl/", "repro_torch/core/", "repro_torch/kernels/",
              "repro_torch/train/", "repro_torch/serve/")
_WHILE_DIRS = ("repro_torch/train/", "repro_torch/serve/")
# what launch/aot_cache.py::_capture records: round_program and every
# function it reaches in fl/round.py and core/
_CAPTURED_ROOT = ("repro_torch/fl/round.py", "round_program")

_SYNC_FUNCS = {"float", "int", "bool", "complex"}
_SYNC_ATTRS = {"item", "tolist", "cpu", "numpy"}
_SYNC_DOTTED = {"np.asarray", "np.array", "numpy.asarray", "numpy.array",
                "torch.cuda.synchronize", "cuda.synchronize"}

# substrings whose presence in the argument expression marks it static
# (shape arithmetic, config / signature fields, literals)
_STATIC_MARKERS = re.compile(
    r"\.shape|\.ndim\b|\.dim\(|\.numel\(|\.size\(|\.dtype\b|\.itemsize|"
    r"\.element_size\(|\blen\(|\.n_[a-z_]+|"
    r"\bcfg\.|\bconfig\.|\bscfg\.|\bself\.[a-z_]*cfg|\bsig\.|\bspec\.|"
    r"\.n_steps\b|\bmath\.|\bnp\.prod\(|\bstr\(")
# a loop is a step loop when its range counts steps, iterations or tokens
_STEP_RANGE = re.compile(r"step|iter|epoch|max_new|n_new|n_tokens|rounds")


def _is_static(arg: ast.AST) -> bool:
    if isinstance(arg, ast.Constant):
        return True
    return bool(_STATIC_MARKERS.search(ast.unparse(arg)))


def classify_sync(call: ast.Call) -> Optional[str]:
    """The host sync ``call`` makes, or None."""
    func = call.func
    name = dotted(func)
    if name in ("torch.cuda.synchronize", "cuda.synchronize"):
        return f"{name}()"
    if isinstance(func, ast.Attribute) and func.attr in _SYNC_ATTRS \
            and not call.args and not _is_static(func.value):
        return f".{func.attr}()"
    if name in _SYNC_DOTTED and call.args and not _is_static(call.args[0]):
        return f"{name}(...)"
    if name in _SYNC_FUNCS and len(call.args) == 1 and \
            not _is_static(call.args[0]):
        return f"{name}(...)"
    return None


def _is_step_loop(loop: ast.AST, path: str) -> bool:
    """A ``for`` over ``range`` of a step, iteration or token count; a
    ``while`` loop in ``serve/`` or ``train/`` (the decode and training
    loops) or one whose test counts steps."""
    if isinstance(loop, ast.While):
        return any(d in path for d in _WHILE_DIRS) or \
            bool(_STEP_RANGE.search(ast.unparse(loop.test)))
    if not isinstance(loop, (ast.For, ast.AsyncFor)):
        return False
    it = loop.iter
    if isinstance(it, ast.Call) and dotted(it.func) == "range":
        return bool(_STEP_RANGE.search(ast.unparse(it)))
    return False


def _pkg_root(path: str) -> Optional[str]:
    norm = path.replace(os.sep, "/")
    i = norm.rfind("repro_torch/")
    return norm[:i] if i >= 0 else None


_CAPTURED_CACHE: Dict[str, Dict[str, Set[str]]] = {}


def captured_functions(root: str) -> Dict[str, Set[str]]:
    """``{repo-relative file: function names}`` that ``_capture`` records:
    ``fl.round.round_program`` and, transitively, the functions it calls
    in its own module and in ``core/`` (by ``<core alias>.name`` or by a
    name imported from ``core``)."""
    if root in _CAPTURED_CACHE:
        return _CAPTURED_CACHE[root]
    out: Dict[str, Set[str]] = {}
    trees: Dict[str, ast.Module] = {}
    round_path = os.path.join(root, _CAPTURED_ROOT[0])
    if not os.path.isfile(round_path):
        _CAPTURED_CACHE[root] = out
        return out

    def parse(rel):
        if rel not in trees:
            with open(os.path.join(root, rel), encoding="utf-8") as f:
                trees[rel] = ast.parse(f.read())
        return trees[rel]

    def core_aliases(tree) -> Tuple[Dict[str, str], Dict[str, Tuple[str, str]]]:
        mods, names = {}, {}
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module:
                if node.module == "repro_torch.core":
                    for a in node.names:
                        mods[a.asname or a.name] = \
                            f"repro_torch/core/{a.name}.py"
                elif node.module.startswith("repro_torch.core."):
                    rel = node.module.replace(".", "/") + ".py"
                    for a in node.names:
                        names[a.asname or a.name] = (rel, a.name)
        return mods, names

    work = [_CAPTURED_ROOT]
    while work:
        rel, fname = work.pop()
        if not os.path.isfile(os.path.join(root, rel)):
            continue
        tree = parse(rel)
        defs = {n.name: n for n in tree.body
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        mods, names = core_aliases(tree)
        for name in (fname,):
            if name not in defs or name in out.get(rel, ()):
                continue
            out.setdefault(rel, set()).add(name)
            for call in ast.walk(defs[name]):
                if not isinstance(call, ast.Call):
                    continue
                f = call.func
                if isinstance(f, ast.Attribute) and \
                        isinstance(f.value, ast.Name) and f.value.id in mods:
                    work.append((mods[f.value.id], f.attr))
                elif isinstance(f, ast.Name):
                    if f.id in names:
                        work.append(names[f.id])
                    elif f.id in defs:
                        work.append((rel, f.id))
    _CAPTURED_CACHE[root] = out
    return out


class HostSyncRule(Rule):
    id = "HOST-SYNC"
    severity = Severity.WARN
    doc = ("device→host sync (.item()/.cpu()/float()/np.asarray/"
           "cuda.synchronize on a tensor) in code a CUDA graph captures "
           "(fl/round.py and the core/ it reaches) or in a step loop of "
           "fl/, core/, kernels/, train/, serve/")
    reference = "HOST-SYNC"
    hazard = ("a sync per step stalls the card; inside a capture it breaks "
              "the CUDA graph")

    def run(self, src: SourceFile) -> Iterable[Finding]:
        norm = src.path.replace("\\", "/")
        root = _pkg_root(norm)
        rel = norm[len(root):] if root is not None else norm
        findings: List[Finding] = []
        seen: Set[int] = set()

        def scan(node, why):
            for call in ast.walk(node):
                if not isinstance(call, ast.Call) or call.lineno in seen:
                    continue
                hit = classify_sync(call)
                if hit is None:
                    continue
                seen.add(call.lineno)
                findings.append(self.finding(
                    src, call.lineno, f"{hit} {why} forces a device sync",
                    "keep the value on the device, or hoist the host "
                    "conversion out of the loop / captured region"))

        captured = captured_functions(root).get(rel, set()) \
            if root is not None else set()
        if captured:
            for fn in src.tree.body:
                if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and fn.name in captured:
                    scan(fn, f"inside '{fn.name}', which a CUDA graph "
                         "capture records,")
        if any(d in norm for d in _LOOP_DIRS):
            for loop in loop_bodies(src.tree):
                if _is_step_loop(loop, norm):
                    for stmt in loop.body:
                        scan(stmt, f"in the step loop at line "
                             f"{loop.lineno}")
        return findings


_CAPTURE_CALLS = {"torch.cuda.graph", "cuda.graph", "torch.cuda.CUDAGraph",
                  "cuda.CUDAGraph", "CUDAGraph",
                  "torch.cuda.make_graphed_callables",
                  "make_graphed_callables", "_build.build", "_build.load",
                  "ctypes.CDLL", "torch.compile"}


class InlineJitRule(Rule):
    id = "CHURN-INLINE-BUILD"
    severity = Severity.WARN
    doc = ("a CUDA graph captured, or a kernel library built or loaded, "
           "inside a loop body — a fresh capture / build every iteration")
    reference = "CHURN-INLINE-JIT"
    hazard = ("capture or nvcc cost and graph memory paid every iteration "
              "instead of once")

    def run(self, src: SourceFile) -> Iterable[Finding]:
        findings: List[Finding] = []
        seen: Set[int] = set()
        for loop in loop_bodies(src.tree):
            for stmt in loop.body:
                for call in ast.walk(stmt):
                    if not isinstance(call, ast.Call) or call.lineno in seen:
                        continue
                    fname = dotted(call.func)
                    if fname in _CAPTURE_CALLS:
                        seen.add(call.lineno)
                        findings.append(self.finding(
                            src, call.lineno,
                            f"{fname}(...) inside a loop body — every "
                            f"iteration captures / builds anew",
                            "hoist it above the loop, or key it in a cache "
                            "(launch.aot_cache.ProgramCache, _build.load "
                            "memoises by source)"))
        return findings


_UNHASHABLE = re.compile(
    r"^(list|dict|set|List|Dict|Set|MutableMapping|MutableSequence|"
    r"np\.ndarray|numpy\.ndarray|ndarray|torch\.Tensor|Tensor)\b")


class StaticArgRule(Rule):
    id = "CHURN-STATIC"
    severity = Severity.WARN
    doc = ("an lru_cache / cache function with a mutable-literal default "
           "(unhashable) or a parameter of an unhashable or identity-hashed "
           "type (list, dict, ndarray, Tensor)")
    reference = "CHURN-STATIC"
    hazard = ("TypeError at the first call, or a miss on every call (and "
              "a tensor kept alive by the cache)")

    def run(self, src: SourceFile) -> Iterable[Finding]:
        findings: List[Finding] = []
        for fn in ast.walk(src.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            dec = next((d for d in fn.decorator_list if self._memo(d)), None)
            if dec is None:
                continue
            a = fn.args
            params = a.posonlyargs + a.args + a.kwonlyargs
            defaults = dict(self._defaults(fn))
            for p in params:
                d = defaults.get(p.arg)
                if isinstance(d, (ast.List, ast.Dict, ast.Set)):
                    findings.append(self.finding(
                        src, dec.lineno,
                        f"memoised parameter '{p.arg}' of '{fn.name}' "
                        f"defaults to a mutable literal — unhashable at the "
                        f"first call", "use a tuple / frozen dataclass "
                        "default"))
                ann = ast.unparse(p.annotation) if p.annotation else ""
                if ann.startswith("Optional["):
                    ann = ann[len("Optional["):]
                if _UNHASHABLE.match(ann):
                    findings.append(self.finding(
                        src, dec.lineno,
                        f"memoised parameter '{p.arg}' of '{fn.name}' is a "
                        f"{ann} — unhashable, or hashed by identity so "
                        f"every call misses", "memoise on shapes / tuples "
                        "and pass the tensor outside the cache"))
        return findings

    @staticmethod
    def _memo(dec: ast.AST) -> bool:
        name = dotted(dec.func if isinstance(dec, ast.Call) else dec)
        return name in ("functools.lru_cache", "lru_cache", "functools.cache",
                        "cache")

    @staticmethod
    def _defaults(fn):
        a = fn.args
        pos = a.posonlyargs + a.args
        yield from ((p.arg, d) for p, d in
                    zip(pos[len(pos) - len(a.defaults):], a.defaults))
        yield from ((p.arg, d) for p, d in zip(a.kwonlyargs, a.kw_defaults)
                    if d is not None)


class ExcSwallowRule(Rule):
    """EXC-SWALLOW — fault-swallowing except clauses in the resilience
    surface (``fl/`` and ``serve/``).

    A bare ``except:`` (or ``except Exception/BaseException:`` whose body
    is only ``pass``/``...``/``continue``) silently eats the very faults
    DESIGN.md §13 requires to land in exactly one verdict bucket — a
    swallowed decode error is a byte-conservation violation waiting to
    happen.  Handle the concrete exception, or turn it into a structured
    ``Rejection`` / ``TransientClientError``.
    """
    id = "EXC-SWALLOW"
    severity = Severity.WARN
    doc = ("bare 'except:' / 'except Exception: pass' in fl/ or serve/ — "
           "faults must become verdicts, not disappear")
    reference = "EXC-SWALLOW"
    hazard = "a lost fault: no verdict, no log, no re-raise"

    _BROAD = {"Exception", "BaseException"}
    _DIRS = ("repro_torch/fl/", "repro_torch/serve/")

    def __init__(self, restrict: Optional[Sequence[str]] = None):
        # restrict=() runs everywhere — the fixture corpus uses it
        self.restrict = self._DIRS if restrict is None else tuple(restrict)

    def run(self, src: SourceFile) -> Iterable[Finding]:
        norm = src.path.replace("\\", "/")
        if self.restrict and not any(d in norm for d in self.restrict):
            return []
        findings: List[Finding] = []
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if node.type is None:
                findings.append(self.finding(
                    src, node.lineno,
                    "bare 'except:' swallows every fault (KeyboardInterrupt "
                    "included) on the resilience surface",
                    "catch the concrete exception and account it — a "
                    "Rejection verdict or TransientClientError, not "
                    "silence"))
            elif dotted(node.type).split(".")[-1] in self._BROAD \
                    and self._swallows(node.body):
                findings.append(self.finding(
                    src, node.lineno,
                    f"'except {dotted(node.type)}: pass' drops the fault "
                    "with no verdict, no log, no re-raise",
                    "handle it or let it propagate — §13's byte ledger "
                    "needs every failure attributed"))
        return findings

    @staticmethod
    def _swallows(body: Sequence[ast.stmt]) -> bool:
        for stmt in body:
            if isinstance(stmt, (ast.Pass, ast.Continue)):
                continue
            if isinstance(stmt, ast.Expr) and isinstance(
                    stmt.value, ast.Constant) and stmt.value.value is ...:
                continue
            return False
        return True
