"""CLI: ``python -m repro_torch.analysis [paths]`` — exit 0 iff no gating
findings.

Default paths: ``src/repro_torch`` and ``chip_smoke.py``.

Options:
  --json PATH     also dump findings as JSON
  --list-rules    print the rule table and exit
  --no-semantic   AST rules only (no module imports, nothing executed)
  --device DEV    where the semantic rules run: cuda (the default; raises
                  without a card) or cpu
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from repro_torch.analysis import core


def _rule_table() -> str:
    lines = []
    for rule in core._default_rules():
        lines.append(f"  {rule.id:<14} {rule.severity!s:<6} {rule.doc}")
        lines.append(f"  {'':<14} {'':<6} reference: {rule.reference}; "
                     f"hazard: {rule.hazard}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="torch- and CUDA-aware lint for the repro_torch port")
    ap.add_argument("paths", nargs="*", default=list(core.DEFAULT_PATHS),
                    help="files or directories to scan (default: "
                         "src/repro_torch chip_smoke.py)")
    ap.add_argument("--json", metavar="PATH", default=None)
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--no-semantic", action="store_true",
                    help="skip semantic rules (no imports, nothing run)")
    ap.add_argument("--device", default=None,
                    help="device of the semantic rules: cuda (default) or "
                         "cpu")
    args = ap.parse_args(argv)

    if args.list_rules:
        print(_rule_table())
        return 0

    t0 = time.time()
    findings = core.analyze_paths(args.paths or list(core.DEFAULT_PATHS),
                                  semantic=not args.no_semantic,
                                  device=args.device)
    elapsed = time.time() - t0
    for f in findings:
        print(f.format())
    gating = core.gating(findings)
    print(f"{core.summarize(findings)}  ({elapsed:.1f}s)")
    if args.json:
        with open(args.json, "w", encoding="utf-8") as fh:
            json.dump({"elapsed_s": elapsed,
                       "findings": [f.__dict__ | {"severity": str(f.severity)}
                                    for f in findings]}, fh, indent=2,
                      default=str)
    return 1 if gating else 0


if __name__ == "__main__":
    sys.exit(main())
