"""flash_roofline.train (%): kernel #6 (``flash_attention``) against its
operation bound (q.k and P.V once each over the live causal pairs,
float32 FMAs at 67 TFLOP/s) at the training shape (local batch x seq,
every head), over its device time in the profiled stretch.  Nothing when
the route does not run the kernel."""
from portbench.rooflines import flash
from portbench.trace import kernel_time


def read(rec):
    if rec.get("kind") != "train":
        return None
    got = kernel_time(rec["prof"], flash.KERNEL)
    if got is None:
        return None
    sec, calls = got
    s, tr = rec["shape"], rec["traffic"]
    elem = 2 if s["dtype"] == "bfloat16" else 4
    bound, _ = flash.bound_s(tr["local_batch"], s["n_heads"],
                             s["n_kv_heads"], tr["seq"], s["head_dim"],
                             elem, s["window"])
    return 100.0 * calls * bound / sec, "%"
