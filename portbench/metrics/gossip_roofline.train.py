"""gossip_roofline.train (%): kernel #2 (``gossip_mix_kernel``) against
its byte bound at the store's shape (n learners, T rows of 128 float32,
K = 1), over its device time in the profiled stretch."""
from portbench.rooflines import gossip
from portbench.trace import kernel_time


def read(rec):
    if rec.get("kind") != "train":
        return None
    got = kernel_time(rec["prof"], gossip.KERNEL)
    if got is None:
        return None
    sec, calls = got
    bound, _ = gossip.bound_s(rec["traffic"]["learners"], rec["store_rows"])
    return 100.0 * calls * bound / sec, "%"
