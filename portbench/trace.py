"""A short profiled stretch and what the per-layer metrics read from it.

``profile(fn)`` runs ``fn()`` under ``torch.profiler`` (CPU and CUDA
activities) between two synchronizes and reduces the trace to a plain
record:

- ``window_s``: the stretch's length on the host clock (the profiler's
  own host cost is inside it);
- ``busy_s``: the union of the device activities' intervals (kernels,
  copies, sets), so that two overlapping kernels count once;
- ``kernels``: {name: [device seconds, count]} over device activities;
- ``launches``: device kernels (copies and sets left out);
- ``device_ops``: the ten names with the most device time;
- ``idle_gaps``: the ten longest gaps between device activities inside
  the stretch, each named by the innermost host operation that was
  running at the gap's middle.
"""
from __future__ import annotations

import time
from collections import defaultdict


def _is_copy(name: str) -> bool:
    return name.lower().startswith(("memcpy", "memset"))


def profile(fn, sync):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as _profile

    sync()
    with _profile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    dev, host = [], []
    for e in prof.events():
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            dev.append((tr.start, tr.end, e.name))
        elif e.device_type == DeviceType.CPU:
            host.append((tr.start, tr.end, e.name))
    return reduce(dev, host, wall)


def reduce(dev, host, wall_s: float) -> dict:
    """``dev``, ``host``: [(start us, end us, name)] on one time base."""
    kernels = defaultdict(lambda: [0.0, 0])
    for s, e, name in dev:
        k = kernels[name]
        k[0] += (e - s) / 1e6
        k[1] += 1
    iv = sorted((s, e) for s, e, _ in dev if e > s)
    busy, gaps = 0.0, []
    cur_s = cur_e = None
    for s, e in iv:
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for g0, g1 in gaps[:10]:
        mid = (g0 + g1) / 2
        best = None
        for s, e, name in host:
            if s <= mid <= e and (best is None or s > best[0]):
                best = (s, name)
        named.append([best[1] if best else "(no host op)",
                      (g1 - g0) / 1e6])
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    return {
        "window_s": wall_s,
        "busy_s": busy / 1e6,
        "kernels": {k: list(v) for k, v in kernels.items()},
        "launches": sum(v[1] for k, v in kernels.items()
                        if not _is_copy(k)),
        "device_ops": [[k[:120], v[0]] for k, v in top],
        "idle_gaps": [[n[:120], s] for n, s in named],
    }


def kernel_time(rec: dict, substring: str):
    """(device seconds, calls) of the kernels whose name holds
    ``substring``; None when none ran."""
    got = [v for k, v in rec["kernels"].items() if substring in k]
    if not got:
        return None
    return sum(v[0] for v in got), sum(v[1] for v in got)
