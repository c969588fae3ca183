"""Hand-written CUDA kernel: paged decode attention (one query per slot).

Port of ``repro/kernels/decode_attention.py::paged_decode_attention_fwd``
(the Pallas TPU kernel) to CUDA C++ for Hopper; the source and its design
note are in ``csrc/decode_attention.cu``.  The wrapper takes CUDA tensors
only — ``kernels.ops.paged_decode_attention`` sends CPU tensors to the
plain version in ``kernels.ref`` — and checks device, dtype (float32),
contiguity and shapes before launching on the current stream.  The kernel
trusts the page table: every id must lie in ``[0, P)``.

``paged_decode_attention_fwd.launches`` counts launches (a plain integer,
reset by whoever wants to count a run).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..cuda_build import load_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"
MAX_GROUP = 16          # query heads per kv head
MAX_HEAD_DIM = 256

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "paged_decode_attention_f32": (
        ctypes.c_int,
        [_P, _P, _P, _P, _P, _P,        # q k_pages v_pages table lengths out
         _I, _I, _I, _I, _I, _I, _I,    # S H KV hd page max_pages window
         _F, _F, _P]),                  # softcap scale stream
    "paged_decode_attention_error_string": (ctypes.c_char_p, [_I]),
}


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
    for name in ("q", "k_pages", "v_pages"):
        if tensors[name].dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got "
                             f"{tensors[name].dtype}")
        if tensors[name].data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel "
                             "loads float4)")
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
    page_table: (S, max_pages) int32; lengths: (S,) int32 -> (S, H, hd).
    All float32 / int32, contiguous, on one CUDA device."""
    _check(q, k_pages, v_pages, page_table, lengths)
    S, H, hd = q.shape
    _, page, KV, _ = k_pages.shape
    lib = load_library(SOURCE, SIGNATURES)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.paged_decode_attention_f32(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            S, H, KV, hd, page, page_table.shape[1], int(window),
            float(attn_softcap), hd ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        msg = lib.paged_decode_attention_error_string(err).decode()
        raise RuntimeError(f"paged_decode_attention launch failed: {msg} "
                           f"(cudaError {err})")
    paged_decode_attention_fwd.launches += 1
    return out


paged_decode_attention_fwd.launches = 0
