"""The port's static invariant auditor (DESIGN §16): AST lint, rules over
the ops a step dispatches, the trace sentinel, and the trainer / launch /
serve audit targets — the twin of ``repro.analysis``.

torch-free at import time: the traced-rule modules (``trace_audit``,
``retrace``, ``targets``) import torch only when used, so
``repro_torch.analysis.lint`` stays a millisecond import.

    python -m repro_torch.analysis.run               # every audit, on the card
    python -m repro_torch.analysis.run --device cpu  # every audit, on the CPU
"""
from .lint import lint_root
from .report import RULES, Finding, format_findings, rule

__all__ = ["Finding", "RULES", "rule", "format_findings", "lint_root",
           "load_all_rules"]


def load_all_rules():
    """Import every rule module (torch included) and return the full
    name -> contract catalog.  DESIGN §16's rule table is this dict."""
    from . import retrace, trace_audit  # noqa: F401  (registration)
    return dict(RULES)
