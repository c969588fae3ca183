"""Kernel #6, the flash attention forward: q.k and P.V once each over the
live (causal, windowed) pairs, 2 FLOPs a multiply-add.  float32 inputs at
the float32 FMA rate (TF32 stays off), bf16 at the tensor cores' rate;
bytes: q, k, v read and the output written once.  The larger time
binds."""
from .. import peaks
from ..flops import causal_pairs

KERNEL = "flash_attention"


def flops(B: int, H: int, S: int, hd: int, window: int = 0) -> float:
    return 4.0 * causal_pairs(S, window) * B * H * hd


def nbytes(B, H, KV, S, hd, elem) -> int:
    return elem * (2 * B * S * H * hd + 2 * B * S * KV * hd)


def bound_s(B, H, KV, S, hd, elem, window=0):
    t_ops = flops(B, H, S, hd, window) / (
        peaks.BF16_FLOPS if elem == 2 else peaks.F32_FLOPS)
    t_bytes = nbytes(B, H, KV, S, hd, elem) / peaks.HBM_BYTES_PER_S
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
