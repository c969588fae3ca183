"""Trace sentinel (DESIGN §16): a step's work stays fixed across operand
swaps — the port's twin of ``repro/analysis/retrace.py``.

The membership tables, controller scale writes and serve admissions are
designed as *operand* changes: new values flow through the same step, and
nothing about the work changes.  The reference pins that with the jit
cache's size.  The port has no ``jax.jit``, so "a compile" becomes two
things the sentinel watches:

* the step's **trace signature** (``StepTrace.signature``): every op it
  dispatches with its outputs' shapes and dtypes, plus the hand kernels
  it launches.  A step that takes another branch, reshapes a buffer or
  launches another kernel dispatches another signature — what a CUDA
  graph of the step could not replay;
* the **CUDA libraries** ``cuda_build`` has loaded: a kernel built or
  loaded inside the window is the port's compile.

``watch(fn)`` wraps a step so that each call runs under a ``StepTrace``
and keeps its signature (the twin of jitting it); ``trace_count(fn)`` is
the number of distinct signatures it has given (the twin of the jit
cache's size).  A window reads

    step = watch(trainer.train_step, device)
    state, _ = step(state, batch)          # warm
    with TraceSentinel(step) as s:
        state = trainer.set_membership(state, mem2)
        state, _ = step(state, batch2)
    # raises RetraceError (or, in collect mode, yields findings)

Every call inside the window must give the signature of the last call
before it; a watched step first called inside the window is a trace, as
a first jit call is a compile.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from .report import Finding, rule
from .trace_audit import StepTrace

__all__ = ["RetraceError", "TraceSentinel", "Watched", "watch",
           "trace_count", "no_retrace"]


class RetraceError(AssertionError):
    """A watched step changed its trace inside a sentinel window."""


class Watched:
    """A step whose every call runs under a ``StepTrace``.

    ``signatures``: the distinct signatures it has given, in order;
    ``history``: each call's signature; ``last_trace``: the last call's
    ``StepTrace``.  ``sync_check``: on a CUDA device, run each call under
    ``torch.cuda.set_sync_debug_mode("error")`` (a host sync inside the
    step raises); targets set it for the calls they audit, after warm-up
    calls that may fill lazily made device tables.  ``watch_bytes`` is
    handed to the trace (``donation_honored``)."""

    def __init__(self, fn: Callable, device=None, label: Optional[str] = None,
                 watch_bytes: Optional[int] = None):
        if not callable(fn):
            raise TypeError(f"{fn!r} is not callable")
        self.fn = fn
        self.device = device
        self.__name__ = label or getattr(fn, "__qualname__", None) or \
            getattr(fn, "__name__", repr(fn))
        self.watch_bytes = watch_bytes
        self.sync_check = False
        self.signatures: List[tuple] = []
        self.history: List[tuple] = []
        self.last_trace: Optional[StepTrace] = None

    def __call__(self, *args, **kwargs):
        trace = StepTrace(self.device, watch_bytes=self.watch_bytes)
        checked = (self.sync_check and self.device is not None
                   and torch.device(self.device).type == "cuda")
        if checked:
            before = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
        try:
            with trace:
                out = self.fn(*args, **kwargs)
        finally:
            if checked:
                torch.cuda.set_sync_debug_mode(before)
        sig = trace.signature()
        if sig not in self.signatures:
            self.signatures.append(sig)
        self.history.append(sig)
        self.last_trace = trace
        return out


def watch(fn: Callable, device=None, label: Optional[str] = None,
          watch_bytes: Optional[int] = None) -> Watched:
    """``fn`` as a ``Watched`` step (a ``Watched`` is returned as is)."""
    if isinstance(fn, Watched):
        return fn
    return Watched(fn, device, label, watch_bytes)


def trace_count(fn) -> int:
    """Distinct trace signatures a watched step has given (0 if never
    called).  Raises TypeError for a callable that is not watched — a
    sentinel over an unwatched callable would vacuously pass."""
    if not isinstance(fn, Watched):
        raise TypeError(
            f"{fn!r} is not watched — pass the step wrapped by "
            "repro_torch.analysis.retrace.watch")
    return len(fn.signatures)


def _libraries() -> int:
    from .. import cuda_build
    return len(cuda_build._loaded)


def _first_difference(a: tuple, b: tuple) -> str:
    ops_a, ops_b = a[0], b[0]
    for i, (x, y) in enumerate(zip(ops_a, ops_b)):
        if x != y:
            return f"op {i}: {x[0]} {list(x[1])} -> {y[0]} {list(y[1])}"
    if len(ops_a) != len(ops_b):
        return f"{len(ops_a)} -> {len(ops_b)} ops"
    return f"kernel launches {dict(a[1])} -> {dict(b[1])}"


class TraceSentinel:
    """Assert a watched step's trace is unchanged across a window of
    operand swaps, and that no kernel library loads inside it.

    ``strict=True`` (default) raises RetraceError on exit; ``strict=False``
    collects into ``self.findings`` for the auditor's report path.  Watched
    steps are labeled by their names unless ``labels`` is given."""

    def __init__(self, *fns, strict: bool = True,
                 labels: Sequence[str] = ()):
        if not fns:
            raise ValueError("TraceSentinel needs at least one watched step")
        for f in fns:
            trace_count(f)                 # TypeError for an unwatched fn
        self.fns = fns
        self.strict = strict
        self.labels = list(labels) or [f.__name__ for f in fns]
        if len(self.labels) != len(fns):
            raise ValueError("labels must match watched fns")
        self.findings: List[Finding] = []

    def __enter__(self):
        self._start = [(len(f.history), f.history[-1] if f.history else None)
                       for f in self.fns]
        self._libs = _libraries()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:      # don't mask the real failure
            return False
        for fn, label, (start, warm) in zip(self.fns, self.labels,
                                            self._start):
            for k, sig in enumerate(fn.history[start:]):
                if sig == warm:
                    continue
                why = ("first traced inside the window" if warm is None
                       else _first_difference(warm, sig))
                self.findings.append(Finding(
                    "no-retrace", label,
                    f"call {k} of the window dispatched another trace "
                    f"({why}) — an operand swap changed the step's work"))
                break
        libs = _libraries()
        if libs != self._libs:
            self.findings.append(Finding(
                "no-retrace", ", ".join(self.labels),
                f"{libs - self._libs} kernel library loaded inside a "
                "sentinel window — the step compiled"))
        if self.strict and self.findings:
            raise RetraceError("\n".join(str(f) for f in self.findings))
        return False


@rule("no-retrace",
      "membership table swaps, controller scale writes, and serve "
      "admissions are operand changes: the step's trace signature must "
      "not change and no kernel library may load")
def no_retrace(action, *fns, labels: Sequence[str] = ()) -> List[Finding]:
    """Run ``action()`` under a non-strict sentinel watching ``fns`` and
    return the findings (empty == no retrace)."""
    with TraceSentinel(*fns, strict=False, labels=labels) as s:
        action()
    return s.findings
