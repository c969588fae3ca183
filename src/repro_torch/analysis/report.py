"""Finding/rule plumbing for the port's static invariant auditor (DESIGN
§16): the port's copy of ``repro/analysis/report.py``, same semantics.

torch-free on purpose: the AST lint pass and the CLI's reporting layer
import this without paying for a torch import.  Every rule implemented in
``trace_audit``/``retrace``/``lint`` registers itself here with a one-line
contract, so the rule catalog the docs promise is generated from the code
that enforces it — a rule cannot exist without a catalog entry and vice
versa.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

__all__ = ["Finding", "RULES", "rule", "format_findings"]


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation.  ``where`` is a ``file:line`` location for AST
    findings and an audit-target name (``trainer.train_step``, ...) for
    traced and sentinel findings."""
    rule: str
    where: str
    message: str

    def __str__(self) -> str:
        return f"{self.where}: [{self.rule}] {self.message}"


# rule name -> one-line contract (the catalog DESIGN §16 documents)
RULES: Dict[str, str] = {}


def rule(name: str, contract: str) -> Callable:
    """Register a rule implementation under ``name``.

    The decorated callable returns ``list[Finding]`` (empty == clean).
    Names are unique: two implementations claiming one name is a bug in the
    auditor itself, so it raises instead of silently shadowing.
    """
    def deco(fn):
        if name in RULES and RULES[name] != contract:
            raise ValueError(f"rule {name!r} registered twice")
        RULES[name] = contract
        fn.rule_name = name
        return fn
    return deco


def format_findings(findings) -> str:
    lines = [str(f) for f in findings]
    lines.append(f"{len(findings)} finding(s)")
    return "\n".join(lines)
