"""decode_roofline.serve (%): kernel #1 (``paged_decode``) against its
byte bound (q and the output once, the K and V rows of every live
position once, at the pool's element size) at the lengths each traced
step handed it (a span around the engine's calls into the model step),
over its device time in the profiled stretch."""
from portbench.rooflines import decode
from portbench.trace import kernel_time


def read(rec):
    if rec.get("kind") != "serve":
        return None
    got = kernel_time(rec["prof"], decode.KERNEL)
    if got is None or not rec["prof_lengths"]:
        return None
    sec, calls = got
    s = rec["shape"]
    per_step = [decode.bound_s(len(ln), s["n_heads"], s["n_kv_heads"],
                               s["head_dim"], rec["pool_elem"], ln,
                               rec["max_pages"], s["window"])[0]
                for ln in rec["prof_lengths"]]
    # one call an attention layer a step; the mean step's bound for each
    # call the trace kept
    mean = sum(per_step) / len(per_step)
    return 100.0 * calls * mean / sec, "%"
