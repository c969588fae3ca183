"""The program's own spans and counters (``repro_torch.obs``; PERF.md,
section 3), as the per-layer metrics read them, and the split of a traced
stretch's device time by span from the profiler's trace.

The program tallies its spans' calls and host seconds, and its counters,
only while the torch profiler records.  A reader takes them as the
record's profiled stretch only where the cell's step span (``train.step``,
``serve.step``) was called exactly the record's ``prof_steps`` times, and
reads None otherwise: where the program keeps no such tallies (a program
without ``repro_torch.obs``), or where a profiler ran outside the stretch
too.

    python3 -m portbench.spans --workload <cell> --seed <n> --seconds <s>

runs the cell traced, as ``portbench.run --trace 1`` does, and prints its
result line, the stretch's device busy time and length a step and the
counters, then each span a step: the program's calls and host ms, and the
trace's split (``reduce``): the kernels' own time, forward and backward
apart, and the idle.
"""
from __future__ import annotations

import sys

STEP = {"train": "train.step", "serve": "serve.step"}


def tallies(rec):
    """(span times, counts) of the program over the record's profiled
    stretch, or None."""
    obs = sys.modules.get("repro_torch.obs")
    if obs is None or not hasattr(obs, "span_times"):
        return None
    times = obs.span_times()
    step = times.get(STEP.get(rec.get("kind")))
    if step is None or step["calls"] != rec.get("prof_steps"):
        return None
    return times, obs.counts()


def host_ms(rec, names):
    """(1e3 x the summed host seconds of the spans ``names``, a step,
    "ms"), or None when none of them was tallied."""
    got = tallies(rec)
    if got is None or not any(s in got[0] for s in names):
        return None
    times = got[0]
    return 1e3 * sum(times[s]["host_s"] for s in names
                     if s in times) / rec["prof_steps"], "ms"


# -- the device time by span, from the profiler's trace (the study entry) ---

_EVAL = "autograd::engine::evaluate_function"


def _is_device(e) -> bool:
    return getattr(e.device_type, "name", str(e.device_type)) == "CUDA"


def reduce(events, names) -> dict:
    """Each device activity of a profiler trace (``prof.events()``) given
    to a span of ``names``, from the trace alone: {key: {"calls",
    "host_s", "device_s", "self_device_s", "idle_s", "kernels": {name:
    self seconds}}}.

    An activity's launch (the host event of its id) goes to the innermost
    span among its host ancestors; under a backward node
    (``evaluate_function``) whose forward op (the same thread and
    ``sequence_nr``) lay inside a span, to ``<span>.bwd``; otherwise to
    the innermost span open on the forward thread when it was launched;
    with no launch or span found, to ``(none)``.  ``device_s`` adds the
    spans inside (``<child>.bwd`` to ``<span>.bwd``); ``idle_s`` holds the
    gaps between activities whose middle falls inside the span on the
    forward thread, innermost."""
    dev = [e for e in events if _is_device(e)
           and not getattr(e, "is_user_annotation", False)]
    host = [e for e in events if not _is_device(e)]
    spans = [e for e in host if e.name in names]
    main = spans[0].thread if spans else None
    opened = sorted((e for e in spans if e.thread == main),
                    key=lambda e: e.time_range.start)

    def inner(e):
        while e is not None and e.name not in names:
            e = e.cpu_parent
        return e

    def open_at(t):
        best = None
        for sp in opened:
            if sp.time_range.start > t:
                break
            if t <= sp.time_range.end:
                best = sp
        return best

    fwd = {}
    for e in host:
        seq = getattr(e, "sequence_nr", -1)
        if seq >= 0 and not e.name.startswith(_EVAL):
            fwd.setdefault((e.thread, seq), inner(e.cpu_parent))
    launch = {e.id: e for e in host if e.name.startswith("cu")}

    def owner(d):
        e = launch.get(d.id)
        if e is None:
            return None, False
        t, node = e.time_range.start, e.cpu_parent
        while node is not None:
            if node.name in names:
                return node, False
            if node.name.startswith(_EVAL):
                sp = fwd.get((node.fwd_thread, node.sequence_nr))
                if sp is not None:
                    return sp, True
            node = node.cpu_parent
        return open_at(t), False

    out = {}

    def tally(key):
        return out.setdefault(key, {"calls": 0, "host_s": 0.0,
                                    "device_s": 0.0, "self_device_s": 0.0,
                                    "idle_s": 0.0, "kernels": {}})
    for sp in spans:
        t = tally(sp.name)
        t["calls"] += 1
        t["host_s"] += (sp.time_range.end - sp.time_range.start) / 1e6
    for d in dev:
        sec = (d.time_range.end - d.time_range.start) / 1e6
        sp, bwd = owner(d)
        t = tally("(none)" if sp is None else sp.name + ".bwd" * bwd)
        t["self_device_s"] += sec
        t["kernels"][d.name] = t["kernels"].get(d.name, 0.0) + sec
        if sp is None:
            t["device_s"] += sec
            continue
        seen = set()
        while sp is not None:
            if sp.name not in seen:
                seen.add(sp.name)
                tally(sp.name + ".bwd" * bwd)["device_s"] += sec
            sp = inner(sp.cpu_parent)
    iv = sorted((d.time_range.start, d.time_range.end) for d in dev)
    end = None
    for s0, s1 in iv:
        if end is not None and s0 > end:
            sp = open_at((end + s0) / 2)
            tally(sp.name if sp is not None else "(none)")["idle_s"] += (
                s0 - end) / 1e6
        end = s1 if end is None else max(end, s1)
    return out


def main(argv=None) -> int:
    import argparse
    import json

    import torch.profiler

    from portbench import run
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(run.CHECKOUT / "src"))
    run.caches()
    kept = []

    class Keep(torch.profiler.profile):       # the stretch's profiler
        def __exit__(self, *exc):
            out = super().__exit__(*exc)
            kept.append(self)
            return out
    torch.profiler.profile = Keep
    out = run.execute(args.workload, args.seed, args.seconds, True)
    out.pop("_readings", None)
    print(json.dumps(out))
    obs = sys.modules.get("repro_torch.obs")
    if obs is None or not kept:
        print("the program keeps no spans")
        return 1
    times, counts = obs.span_times(), obs.counts()
    trace = reduce(kept[-1].events(), obs.SPANS)
    n = times.get("serve.step", times.get("train.step", {})).get("calls")
    if not n:
        print("no step span was recorded")
        return 1
    dev = out["device"]
    print(json.dumps({"steps": n, "busy_ms": 1e3 * dev["busy_s"] / n,
                      "stretch_ms": 1e3 * dev["window_s"] / n,
                      "counts": counts}))
    for name in sorted(set(times) | set(trace)):
        row = {"span": name}
        t = times.get(name)
        if t is not None:
            row["obs.calls"] = t["calls"] / n
            row["obs.host_ms"] = 1e3 * t["host_s"] / n
        for k, v in trace.get(name, {}).items():
            if k == "kernels":
                top = sorted(v.items(), key=lambda kv: -kv[1])[:8]
                row["trace.top_ms"] = [[a[:100], 1e3 * b / n]
                                       for a, b in top]
            else:
                row[f"trace.{k}"] = v / n if k == "calls" else 1e3 * v / n
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
