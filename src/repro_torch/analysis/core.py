"""Static-analysis engine of the port (port of ``repro/analysis/core.py``).

A small rule engine for this package's failure modes: every rule is
either an **AST rule** (runs per source file, pure syntax + local
dataflow — stream discipline of the generators, host syncs, capture and
build churn) or a **semantic rule** (imports the anchor modules it guards
and runs them — the wire contract, the op sequences behind the round
program's CUDA graphs, the launch contract of the hand-written kernels).

Findings carry ``file:line``, a rule id, a severity tier, and a fix hint.
``ERROR`` and ``WARN`` gate (nonzero CLI exit, tier-1 test failure);
``INFO`` is metrics-only.  A finding is suppressed by a same-line
``# lint: disable=RULE`` (comma-separate several ids; ``*`` disables all);
suppressed findings are still collected and counted, they just don't gate.

Semantic rules that execute code run on ``device``: ``cuda`` unless the
caller passes ``"cpu"``.  Without a card, ``cuda`` raises (it is never
quietly skipped).

CLI: ``python -m repro_torch.analysis [paths]`` (see ``__main__.py``).
"""
from __future__ import annotations

import ast
import dataclasses
import enum
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set

DEFAULT_PATHS = ("src/repro_torch", "chip_smoke.py")


class Severity(enum.IntEnum):
    INFO = 0      # metrics only — never gates
    WARN = 1      # gates: suspicious pattern, fix or suppress with a reason
    ERROR = 2     # gates: a proven bug class in this repo

    def __str__(self) -> str:  # "ERROR", not "Severity.ERROR"
        return self.name


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str                 # e.g. "KEY-REUSE"
    severity: Severity
    path: str                 # repo-relative where possible
    line: int                 # 1-indexed
    message: str
    hint: str = ""            # how to fix (or why it's safe to suppress)
    suppressed: bool = False

    def format(self) -> str:
        sup = " [suppressed]" if self.suppressed else ""
        hint = f"  ({self.hint})" if self.hint else ""
        return (f"{self.path}:{self.line}: {self.rule} "
                f"[{self.severity}]{sup} {self.message}{hint}")

    @property
    def gates(self) -> bool:
        return not self.suppressed and self.severity >= Severity.WARN


_SUPPRESS_RE = re.compile(r"#\s*lint:\s*disable=([A-Za-z0-9_*,\- ]+)")


@dataclasses.dataclass
class SourceFile:
    path: str
    text: str
    tree: ast.Module
    # line → set of suppressed rule ids ("*" suppresses every rule)
    suppressions: Dict[int, Set[str]]

    @classmethod
    def load(cls, path: str) -> "SourceFile":
        with open(path, "r", encoding="utf-8") as f:
            text = f.read()
        tree = ast.parse(text, filename=path)
        sups: Dict[int, Set[str]] = {}
        for i, line in enumerate(text.splitlines(), start=1):
            m = _SUPPRESS_RE.search(line)
            if m:
                sups[i] = {r.strip() for r in m.group(1).split(",")
                           if r.strip()}
        return cls(path=path, text=text, tree=tree, suppressions=sups)

    def is_suppressed(self, rule: str, line: int) -> bool:
        sup = self.suppressions.get(line, ())
        return bool(sup) and (rule in sup or "*" in sup)

    def line_of(self, needle: str) -> int:
        """First line holding ``needle`` (1 when none does)."""
        for i, line in enumerate(self.text.splitlines(), start=1):
            if needle in line:
                return i
        return 1


class Rule:
    """Base AST rule: ``run`` yields findings for one parsed file."""

    id: str = ""
    severity: Severity = Severity.WARN
    doc: str = ""
    # the reference rule(s) this one answers to, and the hazard it guards
    reference: str = ""
    hazard: str = ""

    def run(self, src: SourceFile) -> Iterable[Finding]:  # pragma: no cover
        raise NotImplementedError

    def finding(self, src: SourceFile, line: int, message: str,
                hint: str = "", severity: Optional[Severity] = None,
                rule: Optional[str] = None) -> Finding:
        rid = rule or self.id
        sev = self.severity if severity is None else severity
        return Finding(rule=rid, severity=sev,
                       path=src.path, line=line, message=message, hint=hint,
                       suppressed=src.is_suppressed(rid, line))


class SemanticRule(Rule):
    """A rule that inspects *imported* anchor modules instead of syntax.

    ``anchors`` names the repo-relative module files the rule guards; the
    rule only runs when at least one scanned path covers an anchor (so
    ``python -m repro_torch.analysis src/repro_torch/fl`` doesn't probe
    kernels).  ``run_project`` receives the anchor SourceFiles that are in
    scope, for line anchoring and suppression lookup, and the device the
    rule's executed code runs on.
    """

    anchors: Sequence[str] = ()

    def in_scope(self, files: Sequence[SourceFile]) -> List[SourceFile]:
        hits = []
        for f in files:
            norm = f.path.replace(os.sep, "/")
            if any(norm.endswith(a) for a in self.anchors):
                hits.append(f)
        return hits

    def anchor(self, files: Sequence[SourceFile],
               suffix: str) -> Optional[SourceFile]:
        return next((f for f in files if f.path.replace(os.sep, "/")
                     .endswith(suffix)), None)

    def run(self, src: SourceFile) -> Iterable[Finding]:
        return ()

    def run_project(self, files: Sequence[SourceFile], device: str
                    ) -> Iterable[Finding]:  # pragma: no cover
        raise NotImplementedError


def _default_rules() -> List[Rule]:
    # local import: rule modules import this one
    from repro_torch.analysis import compile as compile_rules
    from repro_torch.analysis import hygiene, keyflow, pallas_rules, wire
    return [
        keyflow.KeyDisciplineRule(),
        keyflow.ShardSeedRule(),
        hygiene.HostSyncRule(),
        hygiene.InlineJitRule(),
        hygiene.StaticArgRule(),
        hygiene.ExcSwallowRule(),
        compile_rules.RetraceRule(),
        compile_rules.CacheKeyRule(),
        pallas_rules.LaunchContractRule(),
        wire.WireContractRule(),
    ]


def resolve_device(device: Optional[str]) -> str:
    """``cuda`` unless ``device`` says otherwise; ``cuda`` without a card
    raises."""
    import torch
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch.analysis: the semantic rules run on cuda and no "
            "card is available — pass --device cpu (device='cpu'), or "
            "--no-semantic for the AST rules alone")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"repro_torch.analysis: unsupported device {dev}")
    return str(dev)


def iter_python_files(paths: Sequence[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isfile(p) and p.endswith(".py"):
            out.append(p)
        elif os.path.isdir(p):
            for root, dirs, names in os.walk(p):
                dirs[:] = [d for d in dirs
                           if d not in ("__pycache__", ".git")]
                out.extend(os.path.join(root, n)
                           for n in sorted(names) if n.endswith(".py"))
    return sorted(set(out))


def analyze_paths(paths: Sequence[str], rules: Optional[Sequence[Rule]]
                  = None, semantic: bool = True,
                  device: Optional[str] = None) -> List[Finding]:
    """Run every rule over the .py files under ``paths``.

    AST rules run per file; semantic rules run once iff one of their
    anchor modules is inside the scanned set, on ``device`` (``cuda``
    unless given).  Returns ALL findings (suppressed ones included,
    flagged) sorted by location.
    """
    rules = list(_default_rules() if rules is None else rules)
    files = []
    findings: List[Finding] = []
    for path in iter_python_files(paths):
        try:
            files.append(SourceFile.load(path))
        except SyntaxError as e:
            findings.append(Finding(
                rule="PARSE", severity=Severity.ERROR, path=path,
                line=e.lineno or 1, message=f"syntax error: {e.msg}"))
    for src in files:
        for rule in rules:
            if not isinstance(rule, SemanticRule):
                findings.extend(rule.run(src))
    if semantic:
        scoped = [(rule, rule.in_scope(files)) for rule in rules
                  if isinstance(rule, SemanticRule)]
        scoped = [(rule, in_scope) for rule, in_scope in scoped if in_scope]
        if scoped:
            dev = resolve_device(device)
            for rule, in_scope in scoped:
                findings.extend(rule.run_project(in_scope, dev))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def gating(findings: Iterable[Finding]) -> List[Finding]:
    return [f for f in findings if f.gates]


def summarize(findings: Sequence[Finding]) -> str:
    n_err = sum(1 for f in findings
                if f.severity == Severity.ERROR and not f.suppressed)
    n_warn = sum(1 for f in findings
                 if f.severity == Severity.WARN and not f.suppressed)
    n_info = sum(1 for f in findings
                 if f.severity == Severity.INFO and not f.suppressed)
    n_sup = sum(1 for f in findings if f.suppressed)
    return (f"{len(findings)} findings: {n_err} error, {n_warn} warn, "
            f"{n_info} info, {n_sup} suppressed")


# ---------------------------------------------------------------------------
# shared AST helpers
# ---------------------------------------------------------------------------


def dotted(node: ast.AST) -> str:
    """Best-effort dotted name of an expression ('' when not name-like)."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted(node.value)
        return f"{base}.{node.attr}" if base else node.attr
    return ""


def walk_functions(tree: ast.AST):
    """Yield every FunctionDef/AsyncFunctionDef (module + class + nested)."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def loop_bodies(tree: ast.AST):
    """Yield every ``for`` / ``while`` loop (its body and ``orelse``)."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.For, ast.AsyncFor, ast.While)):
            yield node
