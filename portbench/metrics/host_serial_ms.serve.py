"""host_serial_ms.serve (ms): the engine's host work between a step's
read-back and the next step's model launches, when the device has
nothing queued: admission, the host arrays and page allocation, then
sampling, eviction and bookkeeping; the host time of the program's
``serve.admit``, ``serve.prepare`` and ``serve.finish`` spans a step over
the profiled stretch (``portbench/spans.py``; the profiler's own host
cost inside)."""
from portbench import spans


def read(rec):
    if rec.get("kind") != "serve":
        return None
    return spans.host_ms(rec, ("serve.admit", "serve.prepare",
                               "serve.finish"))
