"""Kernel #1, the paged decode attention: q read and the output written
once, and the K and V rows of every live position (a slot's length,
within its window) read once, at the pool's element size, plus the page
table and the lengths.  q.k and P.V once each at the pool dtype's rate
never bind at one query a slot; the bound is the bytes."""
from .. import peaks

KERNEL = "paged_decode"


def nbytes(S: int, H: int, KV: int, hd: int, elem: int, live: int,
           max_pages: int) -> int:
    """``live``: the positions read over every slot together."""
    return elem * (2 * S * H * hd + 2 * live * KV * hd) \
        + 4 * (S * max_pages + S)


def live_positions(lengths, window: int = 0) -> int:
    return sum(min(n, window) if window else n for n in lengths)


def bound_s(S, H, KV, hd, elem, lengths, max_pages, window=0):
    live = live_positions(lengths, window)
    t_bytes = nbytes(S, H, KV, hd, elem, live, max_pages) \
        / peaks.HBM_BYTES_PER_S
    flops = 4 * live * (H // KV) * KV * hd
    peak = peaks.BF16_FLOPS if elem == 2 else peaks.F32_FLOPS
    t_ops = flops / peak
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
