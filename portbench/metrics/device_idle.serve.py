"""device_idle.serve (%): the share of a step in which no device
activity runs.  The device's busy time a step is the union of the device
activities' intervals (overlapping kernels count once) over the profiled
stretch of engine steps, divided by its steps; the step's length is the traced
run's own window (run without the profiler, whose host cost would
otherwise read as idle), divided by its steps."""


def read(rec):
    if rec.get("kind") != "serve":
        return None
    busy = rec["prof"]["busy_s"] / rec["prof_steps"]
    step = rec["window_s"] / rec["window_steps"]
    return 100.0 * (1.0 - busy / step), "%"
