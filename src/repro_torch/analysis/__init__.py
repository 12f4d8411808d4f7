"""repro_torch.analysis — torch- and CUDA-aware lint + runtime sanitizer
(port of ``repro.analysis``).

Static rules (``python -m repro_torch.analysis``): KEY-REUSE / KEY-CHAIN /
KEY-SHARD generator-stream discipline, HOST-SYNC syncs in captured code and
step loops, CHURN-* capture / build / memo hygiene, the CUDA-* launch
contract of the hand-written kernels, WIRE-CONTRACT codec layout.
Runtime: :func:`repro_torch.analysis.sanitize.sanitize`.
"""
from repro_torch.analysis.core import (Finding, Rule, SemanticRule, Severity,
                                       SourceFile, analyze_paths, gating,
                                       iter_python_files, summarize)
from repro_torch.analysis.sanitize import (KeyReuseError, reset_active,
                                           sanitize)

__all__ = [
    "Finding", "Rule", "SemanticRule", "Severity", "SourceFile",
    "analyze_paths", "gating", "iter_python_files", "summarize",
    "KeyReuseError", "reset_active", "sanitize",
]
