"""Kernel #2, ``gossip_mix_update_flat`` on the (n, T, 128) float32 store
with momentum: every distinct tensor the update must touch, read once and
written once (w, which is also the remote stack, g and mu in; w' and mu'
out) plus the partner and coefficient tables.  The bound is the bytes at
the HBM rate; 6 FLOPs an element never bind."""
from .. import peaks

KERNEL = "gossip_mix_kernel"


def nbytes(n: int, T: int, K: int = 1, cols: int = 4) -> int:
    elems = n * T * 128
    return 5 * elems * 4 + K * n * 4 + n * cols * 4


def bound_s(n: int, T: int, K: int = 1, cols: int = 4):
    t_bytes = nbytes(n, T, K, cols) / peaks.HBM_BYTES_PER_S
    t_ops = 6 * n * T * 128 / peaks.F32_FLOPS
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
