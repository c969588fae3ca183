"""Hand-written CUDA kernel: paged decode attention (one query per slot).

Port of ``repro/kernels/decode_attention.py::paged_decode_attention_fwd``
(the Pallas TPU kernel) to CUDA C++ for Hopper; the source and its design
note are in ``csrc/decode_attention.cu``.  The wrapper takes CUDA tensors
only — ``kernels.ops.paged_decode_attention`` sends CPU tensors to the
plain version in ``kernels.ref`` — and checks device, dtype (float32 or
bf16, one for q and both pools), contiguity and shapes before launching on
the current stream.  The kernel trusts the page table: every id must lie
in ``[0, P)``.

Each call launches one device kernel: one block per (split, kv head,
slot) over a page-aligned range of the slot's history (``split_plan``
picks the ranges from shapes alone, never from ``lengths``, so the call
makes no host sync), holding every query head of its kv head — any G =
H / KV the reference takes (``group_tiles`` cuts the heads into tiles
only past 8,192 accumulator elements a block).  bf16 pools with 16 to
128 heads a kv head at hd 64 or 128 run on the tensor cores, the rest
in float32 FMAs (``kernel_for``).  A block with no live
token leaves at once; a slot's only live split writes its output itself;
where a slot has more, the last of them to finish merges their partials
in split order.  The
partials and the blocks' ticket counters live in scratch kept per
(device, stream) and grown as needed: the kernel leaves every counter at
0, so a stream's calls, which run in order, can share them.

``paged_decode_attention_fwd.launches`` counts wrapper calls (a plain
integer, reset by whoever wants to count a run).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from ..cuda_build import load_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"
MAX_HEAD_DIM = 256
# a block's accumulators: 256 threads x 32 registers; its shared memory:
# the card's per-block limit (H100: 227 KB)
MAX_BLOCK_ELEMS = 256 * 32
SMEM_LIMIT = 232_448
TILE, STAGES = 32, 3    # csrc/decode_attention.cu: kTile, kStages
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# split_plan's targets: blocks in flight per SM, and the tokens a split
# holds at least (two 16-token pages) and at most
BLOCKS_PER_SM = 4
MIN_SPLIT_TOKENS = 32
MAX_SPLIT_TOKENS = 512

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "paged_decode_attention": (
        ctypes.c_int,
        [_P, _P, _P, _P, _P, _P,        # q k_pages v_pages table lengths out
         _P, _P,                        # partials, tickets (scratch)
         _I, _I,                        # dtype tensor_cores
         _I, _I, _I, _I, _I, _I, _I,    # S H KV gtiles hd page max_pages
         _I, _I, _I,                    # splits split_tokens window
         _F, _F, _P]),                  # softcap scale stream
    "paged_decode_attention_error_string": (ctypes.c_char_p, [_I]),
}


@functools.lru_cache(maxsize=None)
def split_plan(max_pages: int, page: int, n_slots: int, n_kv: int,
               n_sm: int, per_sm: int = BLOCKS_PER_SM):
    """(splits, pages_per_split) for a (splits, KV, S) grid: enough splits
    for ``per_sm`` blocks per SM and at most ``MAX_SPLIT_TOKENS`` tokens a
    split, but no split under ``MIN_SPLIT_TOKENS`` (or one page).
    Split i covers the logical tokens [i, i + 1) * pages_per_split * page;
    together they cover the slot's buffer of max_pages * page tokens once.
    Plain integers in and out: the serve step must not read ``lengths``
    on the host."""
    W = max_pages * page
    want = max(-(-per_sm * n_sm // (n_slots * n_kv)),
               -(-W // MAX_SPLIT_TOKENS), 1)
    min_pages = max(1, -(-MIN_SPLIT_TOKENS // page))
    want = min(want, max(1, max_pages // min_pages))
    pages = -(-max_pages // want)
    return -(-max_pages // pages), pages


def smem_bytes(heads: int, hd: int, itemsize: int, split_tokens: int) -> int:
    """Shared memory of a block that owns ``heads`` query heads: the
    source's ``split_smem_bytes``."""
    row = (hd + 16 // itemsize) * itemsize
    return (STAGES * 2 * TILE * row + 4 * heads * (hd + 4 + TILE + 3)
            + 4 * split_tokens)


@functools.lru_cache(maxsize=None)
def group_tiles(G: int, hd: int, itemsize: int, split_tokens: int) -> int:
    """How many tiles the G query heads of a kv head are cut into: 1 (one
    block reads each K/V row for all G) unless a block's accumulators
    would pass ``MAX_BLOCK_ELEMS`` or its shared memory ``SMEM_LIMIT``."""
    tiles = -(-G * hd // MAX_BLOCK_ELEMS)
    while smem_bytes(-(-G // tiles), hd, itemsize, split_tokens) > SMEM_LIMIT:
        if tiles == G:
            raise ValueError(f"hd {hd}, {split_tokens} tokens a split: one "
                             "head's tiles pass the shared memory")
        tiles += 1
    return tiles


@functools.lru_cache(maxsize=None)
def launch_plan(n_slots: int, H: int, KV: int, hd: int, itemsize: int,
                page: int, max_pages: int, n_sm: int):
    """(gtiles, splits, pages_per_split) of a call: the head tiles, then
    the splits for the (splits, KV * gtiles, S) grid, aiming at
    ``BLOCKS_PER_SM`` blocks of 128 threads an SM, half as many of 256
    (a block's heads past 4,096 accumulator elements)."""
    G = H // KV
    tiles = -(-G * hd // MAX_BLOCK_ELEMS)
    while True:
        wide = -(-G // tiles) * hd > MAX_BLOCK_ELEMS // 2
        splits, pages = split_plan(max_pages, page, n_slots, KV * tiles, n_sm,
                                   BLOCKS_PER_SM // 2 if wide else
                                   BLOCKS_PER_SM)
        need = group_tiles(G, hd, itemsize, pages * page)
        if need <= tiles:
            return tiles, splits, pages
        tiles = need


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# (device index, stream) -> [partials (float32), tickets (int32, all 0)]
_scratch = {}


def _scratch_for(device, stream: int, n_part: int, n_tickets: int):
    buf = _scratch.setdefault((device.index, stream), [None, None])
    if buf[0] is None or buf[0].numel() < n_part:
        buf[0] = torch.empty((n_part,), dtype=torch.float32, device=device)
    if buf[1] is None or buf[1].numel() < n_tickets:
        buf[1] = torch.zeros((n_tickets,), dtype=torch.int32, device=device)
    return buf


def kernel_for(dtype, G: int, hd: int, gtiles: int = 1) -> str:
    """Which kernel runs: ``"tc"`` (q.k and P.V on the tensor cores) for
    bf16 pools with 16 <= G <= 128 query heads a kv head at hd 64 or 128
    in one head tile, ``"fma"`` (float32 FMAs) otherwise.  Static: never
    a fallback."""
    if (dtype == torch.bfloat16 and gtiles == 1 and 16 <= G <= 128
            and hd in (64, 128)):
        return "tc"
    return "fma"


def check_shapes(q_shape, pool_shape, dtype):
    """The shape rule of ``paged_decode_attention_fwd`` for q (S, H, hd)
    and pools (P, page, KV, hd) in ``dtype``, without tensors: raises
    ValueError on what the kernel does not take."""
    if dtype not in DTYPES:
        raise ValueError(f"q must be float32 or bfloat16, got {dtype}")
    if len(q_shape) != 3 or len(pool_shape) != 4:
        raise ValueError(f"q must be (S, H, hd) and the pools "
                         f"(P, page, KV, hd); got {tuple(q_shape)}, "
                         f"{tuple(pool_shape)}")
    _, H, hd = q_shape
    KV = pool_shape[2]
    if pool_shape[3] != hd:
        raise ValueError(f"pool shape {tuple(pool_shape)} does not fit q "
                         f"{tuple(q_shape)}")
    if KV < 1 or H % KV:
        raise ValueError(f"H={H}, KV={KV}: need H % KV == 0")
    if hd % 16 or hd > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd}: need a multiple of 16 up to "
                         f"{MAX_HEAD_DIM}")


def _check(q, k_pages, v_pages, page_table, lengths):
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got q on "
                         f"{q.device} (ops.paged_decode_attention sends CPU "
                         "tensors to the plain version)")
    tensors = {"q": q, "k_pages": k_pages, "v_pages": v_pages,
               "page_table": page_table, "lengths": lengths}
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}, "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    check_shapes(q.shape, k_pages.shape, q.dtype)
    for name in ("k_pages", "v_pages"):
        if tensors[name].dtype != q.dtype:
            raise ValueError(f"{name} is {tensors[name].dtype}, q "
                             f"{q.dtype}: the kernel takes one dtype")
    for name in ("q", "k_pages", "v_pages"):
        if tensors[name].data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel "
                             "copies 16-byte rows)")
    for name in ("page_table", "lengths"):
        if tensors[name].dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got "
                             f"{tensors[name].dtype}")
    if v_pages.shape != k_pages.shape:
        raise ValueError(f"pool shapes {tuple(k_pages.shape)}, "
                         f"{tuple(v_pages.shape)} differ")
    S = q.shape[0]
    if page_table.dim() != 2 or page_table.shape[0] != S \
            or tuple(lengths.shape) != (S,):
        raise ValueError(f"page_table {tuple(page_table.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not have {S} slots")


def paged_decode_attention_fwd(q, k_pages, v_pages, page_table, lengths, *,
                               window: int = 0, attn_softcap: float = 0.0):
    """q: (S, H, hd); k_pages, v_pages: (P, page, KV, hd);
    page_table: (S, max_pages) int32; lengths: (S,) int32 -> (S, H, hd) in
    q's dtype.  q and the pools float32 or bf16 (one dtype), contiguous,
    on one CUDA device."""
    _check(q, k_pages, v_pages, page_table, lengths)
    S, H, hd = q.shape
    _, page, KV, _ = k_pages.shape
    max_pages = page_table.shape[1]
    gtiles, splits, pages = launch_plan(S, H, KV, hd, q.element_size(), page,
                                        max_pages, _sm_count(q.device.index))
    lib = load_library(SOURCE, SIGNATURES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    # the splits' partials: acc (splits * S * H * hd), then (m, l) pairs
    part, tickets = _scratch_for(q.device, stream, splits * S * H * (hd + 2),
                                 S * KV * gtiles)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.paged_decode_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            part.data_ptr(), tickets.data_ptr(), DTYPES[q.dtype],
            int(kernel_for(q.dtype, H // KV, hd, gtiles) == "tc"),
            S, H, KV, gtiles, hd, page, max_pages, splits, pages * page,
            int(window), float(attn_softcap), hd ** -0.5, stream)
    if err:
        msg = lib.paged_decode_attention_error_string(err).decode()
        raise RuntimeError(f"paged_decode_attention launch failed: {msg} "
                           f"(cudaError {err})")
    paged_decode_attention_fwd.launches += 1
    return out


paged_decode_attention_fwd.launches = 0
