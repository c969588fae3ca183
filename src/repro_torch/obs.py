"""Spans and counters at the port's layer boundaries.

The one switch is the torch profiler.  While ``torch.profiler.profile``
records, ``span(name)`` enters a host event of that name and adds its
calls and host seconds to a tally, and ``count(name, n)`` adds ``n`` to a
tally.  Otherwise both cost one attribute read and do nothing.

The host event lies in the profiler's host timeline, the parent of the ops
run inside it, so a reader of the trace gives each kernel to the span that
launched it, and a backward kernel to the span of its forward op (autograd
carries the forward op's ``sequence_nr``); nothing here times the device.
It is a plain record function, not a user annotation
(``torch.profiler.record_function``): the profiler copies a user
annotation onto the device's timeline as an activity of its own, which a
reader of device activities would count as a kernel and as busy time.

Tallies are cumulative over the process and kept in memory only;
``reset()`` empties them.
"""
from __future__ import annotations

import time
from contextlib import nullcontext

import torch
from torch.autograd import profiler as _profiler

SPANS = (
    "train.step", "train.grads", "train.backward", "train.update",
    "train.stats",
    "model.embed", "model.attn", "model.mamba", "model.xlstm", "model.mlp",
    "model.moe", "model.head",
    "kernel.paged_decode", "kernel.gossip_update", "kernel.flash_fwd",
    "kernel.flash_bwd",
    "serve.step", "serve.admit", "serve.prepare", "serve.model",
    "serve.readback", "serve.finish",
)
COUNTERS = ("serve.slot_steps", "serve.tokens")

_NULL = nullcontext()
_counts: dict = {}
_times: dict = {}     # name: [calls, host seconds]
_host_event = getattr(torch._C._profiler, "_RecordFunctionFast", None)


def span(name: str):
    if not _profiler._is_profiler_enabled:
        return _NULL
    if name not in SPANS:
        raise ValueError(f"unknown span {name!r}")
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    if _profiler._is_profiler_enabled:
        if name not in COUNTERS:
            raise ValueError(f"unknown counter {name!r}")
        _counts[name] = _counts.get(name, 0) + n


def counts() -> dict:
    return dict(_counts)


def span_times() -> dict:
    """{name: {"calls", "host_s"}} over every closed span."""
    return {k: {"calls": c, "host_s": s} for k, (c, s) in _times.items()}


def reset() -> None:
    _counts.clear()
    _times.clear()


class _Span:
    __slots__ = ("name", "rf", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = _host_event(self.name) if _host_event else _NULL
        self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t = _times.setdefault(self.name, [0, 0.0])
        t[0] += 1
        t[1] += time.perf_counter() - self.t0
        self.rf.__exit__(*exc)
        return False
