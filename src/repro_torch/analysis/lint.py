"""AST lint pass (DESIGN §16): the port's own copy of
``repro/analysis/lint.py``, the same four rules with the same findings.

Four repo-specific rules that need no tracing, so they run in milliseconds
with no torch import — the first gate of ``python -m
repro_torch.analysis.run``:

* ``no-host-sync`` — in hot-path modules, ``.item()`` / ``np.asarray`` /
  ``block_until_ready`` must carry an explicit ``# lint: allow-host-sync``
  annotation on the statement.  Hot-path modules are the per-step host
  loops (``HOT_PATHS``); any other file can opt in with a
  ``# lint: hot-path`` marker anywhere in the file.  Setup-time numpy code
  (schedule compilation, topology matrices, checkpoint I/O) is deliberately
  out of scope — ``np`` on host tables is not a device sync.
* ``no-id-cache`` — no dict access keyed by ``id(...)``: CPython reuses
  ids after GC, so an ``id()``-keyed jit cache silently cross-wires
  entries (the serve-cache bug this rule pins).
* ``kernel-oracle`` — every kernel module in ``kernels/`` has a ``*_ref``
  oracle in ``ref.py`` named after it and a dispatcher import in
  ``ops.py``.  A kernel nothing can cross-check is untestable by the
  repo's kernel/oracle contract (DESIGN §7).
* ``design-refs`` — every ``DESIGN §N`` reference in code, tests, and docs
  resolves to a ``## §N`` heading in DESIGN.md.

``lint_root(root)`` runs all four over a tree; per-rule entry points take
(path, source) or small inputs so tests can feed fixture programs directly.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Iterable, List, Optional, Sequence

from .report import Finding, rule

__all__ = [
    "HOT_PATHS", "SUPPRESS", "HOT_MARKER", "lint_root",
    "no_host_sync", "no_id_cache", "kernel_oracle", "design_refs",
]

SUPPRESS = "# lint: allow-host-sync"
HOT_MARKER = "# lint: hot-path"

# per-step host loops: the modules where an un-annotated host sync is a
# latency bug, not bookkeeping
HOT_PATHS = (
    "src/repro/serve/engine.py",
    "src/repro/serve/bridge.py",
    "src/repro/core/trainer.py",
    "src/repro/core/faults.py",
    "src/repro/core/flatstate.py",
    "src/repro/launch/train.py",
    "src/repro/kernels/ops.py",
    # the port's twins of the same loops
    "src/repro_torch/serve/engine.py",
    "src/repro_torch/serve/bridge.py",
    "src/repro_torch/core/trainer.py",
    "src/repro_torch/core/faults.py",
    "src/repro_torch/core/flatstate.py",
    "src/repro_torch/launch/train.py",
    "src/repro_torch/kernels/ops.py",
)

# 'fixtures' holds seeded-violation trees (tests/fixtures/lint_violations):
# they are lint SUBJECTS only when passed as the root, never as part of it
_SKIP_DIRS = {".git", "__pycache__", ".pytest_cache", "node_modules",
              ".ruff_cache", "fixtures"}


def _skipped(path: Path, root: Path) -> bool:
    return bool(_SKIP_DIRS.intersection(path.relative_to(root).parts))


def _py_files(root: Path) -> List[Path]:
    return sorted(p for p in root.rglob("*.py") if not _skipped(p, root))


def _parse(path: Path, source: str,
           findings: List[Finding]) -> Optional[ast.AST]:
    try:
        return ast.parse(source)
    except SyntaxError as e:                  # a lint pass must not crash
        findings.append(Finding(
            "no-host-sync", f"{path}:{e.lineno or 0}",
            f"unparseable file: {e.msg}"))
        return None


def _numpy_aliases(tree: ast.AST) -> set:
    """Names bound to the numpy module in this file (``np``, ``numpy``...).
    ``jnp.asarray`` never syncs; only the real-numpy aliases are flagged."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "numpy":
                    out.add(a.asname or "numpy")
    return out


def _suppressed_lines(source: str) -> set:
    return {i for i, line in enumerate(source.splitlines(), start=1)
            if SUPPRESS in line}


def _node_lines(node: ast.AST) -> range:
    return range(node.lineno, (getattr(node, "end_lineno", None)
                               or node.lineno) + 1)


@rule("no-host-sync",
      ".item()/np.asarray/block_until_ready in a hot-path module must be "
      "annotated '# lint: allow-host-sync' (every sync is a decision)")
def no_host_sync(path, source: str) -> List[Finding]:
    findings: List[Finding] = []
    tree = _parse(path, source, findings)
    if tree is None:
        return findings
    np_names = _numpy_aliases(tree)
    ok_lines = _suppressed_lines(source)

    def flag(node, what):
        if not ok_lines.intersection(_node_lines(node)):
            findings.append(Finding(
                "no-host-sync", f"{path}:{node.lineno}",
                f"{what} in a hot-path module without {SUPPRESS!r}"))

    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if isinstance(fn, ast.Attribute):
            if fn.attr == "item" and not node.args:
                flag(node, ".item() (device->host scalar pull)")
            elif fn.attr == "block_until_ready":
                flag(node, "block_until_ready (full device sync)")
            elif (fn.attr == "asarray" and isinstance(fn.value, ast.Name)
                  and fn.value.id in np_names):
                flag(node, f"{fn.value.id}.asarray on device values "
                           "(host transfer)")
        elif isinstance(fn, ast.Name) and fn.id == "block_until_ready":
            flag(node, "block_until_ready (full device sync)")
    return findings


def _contains_id_call(node: ast.AST) -> bool:
    return any(isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
               and n.func.id == "id" for n in ast.walk(node))


@rule("no-id-cache",
      "no dict access keyed by id(...): CPython reuses ids after GC, so "
      "an id()-keyed cache silently cross-wires entries")
def no_id_cache(path, source: str) -> List[Finding]:
    findings: List[Finding] = []
    tree = _parse(path, source, [])
    if tree is None:
        return findings
    for node in ast.walk(tree):
        if isinstance(node, ast.Subscript) and _contains_id_call(node.slice):
            findings.append(Finding(
                "no-id-cache", f"{path}:{node.lineno}",
                "subscript keyed by id(...) — key the cache by the object "
                "itself (WeakKeyDictionary) or an attribute on it"))
        elif (isinstance(node, ast.Call)
              and isinstance(node.func, ast.Attribute)
              and node.func.attr in ("get", "setdefault", "pop")
              and node.args and _contains_id_call(node.args[0])):
            findings.append(Finding(
                "no-id-cache", f"{path}:{node.lineno}",
                f".{node.func.attr}(id(...)) lookup — key the cache by the "
                "object itself, not its transient id"))
    return findings


def _def_names(path: Path) -> set:
    try:
        tree = ast.parse(path.read_text())
    except (OSError, SyntaxError):
        return set()
    return {n.name for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def _relative_imports(path: Path) -> set:
    """Module stems imported via ``from .X import ...`` in ``path``."""
    try:
        tree = ast.parse(path.read_text())
    except (OSError, SyntaxError):
        return set()
    return {n.module for n in ast.walk(tree)
            if isinstance(n, ast.ImportFrom) and n.level == 1 and n.module}


@rule("kernel-oracle",
      "every kernel module in kernels/ has a *_ref oracle in ref.py and a "
      "dispatcher import in ops.py (an uncheckable kernel is untestable)")
def kernel_oracle(kernels_dir) -> List[Finding]:
    kernels_dir = Path(kernels_dir)
    findings: List[Finding] = []
    ref_py, ops_py = kernels_dir / "ref.py", kernels_dir / "ops.py"
    for req in (ref_py, ops_py):
        if not req.exists():
            findings.append(Finding(
                "kernel-oracle", str(kernels_dir),
                f"kernels package has no {req.name}"))
    oracle_names = {n for n in _def_names(ref_py) if n.endswith("_ref")}
    dispatched = _relative_imports(ops_py)
    for mod in sorted(kernels_dir.glob("*.py")):
        stem = mod.stem
        if stem in ("__init__", "ops", "ref"):
            continue
        if not any(stem in name for name in oracle_names):
            findings.append(Finding(
                "kernel-oracle", str(mod),
                f"kernel module {stem!r} has no '*{stem}*_ref' oracle in "
                "ref.py"))
        if stem not in dispatched:
            findings.append(Finding(
                "kernel-oracle", str(mod),
                f"kernel module {stem!r} is not imported by the ops.py "
                "dispatcher"))
    return findings


_REF_RE = re.compile(r"DESIGN(?:\.md)?\s+§(\d+)")
_HEADING_RE = re.compile(r"^##\s+§(\d+)\b", re.M)


@rule("design-refs",
      "every 'DESIGN §N' reference in code and docs resolves to a '## §N' "
      "heading in DESIGN.md")
def design_refs(root, files: Optional[Iterable[Path]] = None
                ) -> List[Finding]:
    root = Path(root)
    design = root / "DESIGN.md"
    sections = (set(_HEADING_RE.findall(design.read_text()))
                if design.exists() else set())
    if files is None:
        files = [p for pat in ("*.py", "*.md")
                 for p in root.rglob(pat)
                 if not _skipped(p, root) and p.name != "DESIGN.md"]
    findings: List[Finding] = []
    for path in sorted(files):
        try:
            text = Path(path).read_text()
        except (OSError, UnicodeDecodeError):
            continue
        for i, line in enumerate(text.splitlines(), start=1):
            for sec in _REF_RE.findall(line):
                if sec not in sections:
                    findings.append(Finding(
                        "design-refs", f"{path}:{i}",
                        f"reference to DESIGN §{sec} but DESIGN.md has no "
                        f"'## §{sec}' heading"))
    return findings


def lint_root(root, hot_paths: Optional[Sequence[str]] = None
              ) -> List[Finding]:
    """Run all four AST rules over a repo (or fixture) tree."""
    root = Path(root)
    findings: List[Finding] = []

    hot = {root / p for p in (HOT_PATHS if hot_paths is None else hot_paths)}
    for path in _py_files(root):
        try:
            source = path.read_text()
        except (OSError, UnicodeDecodeError):
            continue
        if path in hot or HOT_MARKER in source:
            findings.extend(no_host_sync(path, source))
        findings.extend(no_id_cache(path, source))

    for kernels_dir in sorted(p for p in root.rglob("kernels")
                              if p.is_dir() and not _skipped(p, root)):
        findings.extend(kernel_oracle(kernels_dir))

    findings.extend(design_refs(root))
    return findings
