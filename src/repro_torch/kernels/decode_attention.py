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
makes no host sync).  A block with no live token leaves at once; a
slot's only live split writes its output itself; where a slot has more,
the last of them to finish merges their partials in split order.  The
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
MAX_GROUP = 16          # query heads per kv head
MAX_HEAD_DIM = 256
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
         _I, _I, _I, _I, _I, _I, _I,    # dtype S H KV hd page max_pages
         _I, _I, _I,                    # splits split_tokens window
         _F, _F, _P]),                  # softcap scale stream
    "paged_decode_attention_error_string": (ctypes.c_char_p, [_I]),
}


@functools.lru_cache(maxsize=None)
def split_plan(max_pages: int, page: int, n_slots: int, n_kv: int,
               n_sm: int):
    """(splits, pages_per_split) for a (splits, KV, S) grid: enough splits
    for ``BLOCKS_PER_SM`` blocks per SM and at most ``MAX_SPLIT_TOKENS``
    tokens a split, but no split under ``MIN_SPLIT_TOKENS`` (or one page).
    Split i covers the logical tokens [i, i + 1) * pages_per_split * page;
    together they cover the slot's buffer of max_pages * page tokens once.
    Plain integers in and out: the serve step must not read ``lengths``
    on the host."""
    W = max_pages * page
    want = max(-(-BLOCKS_PER_SM * n_sm // (n_slots * n_kv)),
               -(-W // MAX_SPLIT_TOKENS), 1)
    min_pages = max(1, -(-MIN_SPLIT_TOKENS // page))
    want = min(want, max(1, max_pages // min_pages))
    pages = -(-max_pages // want)
    return -(-max_pages // pages), pages


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
    if q.dtype not in DTYPES:
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
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
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError(f"q must be (S, H, hd) and the pools "
                         f"(P, page, KV, hd); got {tuple(q.shape)}, "
                         f"{tuple(k_pages.shape)}")
    S, H, hd = q.shape
    _, _, KV, hd_k = k_pages.shape
    if v_pages.shape != k_pages.shape or hd_k != hd:
        raise ValueError(f"pool shapes {tuple(k_pages.shape)}, "
                         f"{tuple(v_pages.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if H % KV or H // KV > MAX_GROUP:
        raise ValueError(f"H={H}, KV={KV}: need H % KV == 0 and "
                         f"H / KV <= {MAX_GROUP}")
    if hd % 16 or hd > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd}: need a multiple of 16 up to "
                         f"{MAX_HEAD_DIM}")
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
    splits, pages = split_plan(max_pages, page, S, KV,
                               _sm_count(q.device.index))
    lib = load_library(SOURCE, SIGNATURES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    # the splits' partials: acc (splits * S * H * hd), then (m, l) pairs
    part, tickets = _scratch_for(q.device, stream, splits * S * H * (hd + 2),
                                 S * KV)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.paged_decode_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            part.data_ptr(), tickets.data_ptr(), DTYPES[q.dtype],
            S, H, KV, hd, page, max_pages, splits, pages * page,
            int(window), float(attn_softcap), hd ** -0.5, stream)
    if err:
        msg = lib.paged_decode_attention_error_string(err).decode()
        raise RuntimeError(f"paged_decode_attention launch failed: {msg} "
                           f"(cudaError {err})")
    paged_decode_attention_fwd.launches += 1
    return out


paged_decode_attention_fwd.launches = 0
