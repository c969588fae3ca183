"""step_mfu.train (%): the trainer's whole step against the peak of the
configuration's compute dtype (float32: 67 TFLOP/s; TF32 stays off).
Model FLOPs of a step from shapes (``flops.train_flops``: 6 x the
parameters a token multiplies through x tokens, plus causal attention,
nothing recomputed), times the steps of the traced run's window (run
without the profiler), over the window's seconds."""
from portbench import flops, peaks


def read(rec):
    if rec.get("kind") != "train":
        return None
    s, tr = rec["shape"], rec["traffic"]
    f = flops.train_flops(s, tr["learners"] * tr["local_batch"], tr["seq"])
    rate = f * rec["window_steps"] / rec["window_s"]
    return 100.0 * rate / peaks.COMPUTE_PEAK[s["dtype"]], "%"
