"""step_mfu.serve (%): the engine's whole step against the bf16 peak
(989 TFLOP/s): 2 x the parameters a token multiplies through (a MoE
layer's top-k experts) for every token fed, plus q.k and P.V over each
fed token's context, summed over the traced run's window (run without
the profiler; the positions read from a span around the engine's calls
into the model step), over the window's seconds."""
from portbench import flops, peaks


def read(rec):
    if rec.get("kind") != "serve":
        return None
    s = rec["shape"]
    f = sum(flops.decode_flops(s, c) for c in rec["window_contexts"])
    return 100.0 * f / rec["window_s"] / peaks.COMPUTE_PEAK[s["dtype"]], "%"
