"""Hand-written CUDA kernels: fused Lanczos reorthogonalization, the dots
and the axpy of one classical Gram-Schmidt sweep over the stacked basis.

Port of ``repro/kernels/reorth.py::reorth_dots`` and ``reorth_axpy`` (the
Pallas TPU kernels) to CUDA C++ for Hopper; the source and its design note
are in ``csrc/reorth.cu``.  The wrappers take CUDA tensors only —
``kernels.ops.reorthogonalize`` sends CPU tensors to the plain version in
``kernels.ref`` — and check devices, dtypes, contiguity, 16-byte
alignment, shapes and the basis size before launching on the current
stream.

  * ``reorth_dots(basis, w, mask)``: all M dots <v_k, w> in one pass over
    {V, w} (a deterministic two-stage reduction), times ``mask``.
  * ``reorth_axpy(w, basis, dots, out=None)``: w - sum_k d_k v_k in one
    pass; ``out`` may be ``w`` itself (in place).

One CGS sweep (the reference's ``reorth_pass``) is the dots, then the
axpy: ``kernels.ops.reorthogonalize`` runs two.

Each wrapper's ``launches`` counts its launches (a plain integer, reset by
whoever wants to count a run).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..cuda_build import load_library
from .gossip_mix import overlaps

SOURCE = Path(__file__).resolve().parent / "csrc" / "reorth.cu"
LANE = 128
MAX_VECTORS = 64            # kMaxM in the source: Lanczos m + 1 <= 64

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SIGNATURES = {
    "reorth_dots_blocks": (_L, [_L]),
    "reorth_dots_f32": (_I, [_P, _P, _P, _P, _P, _I, _L, _P]),
    "reorth_axpy_f32": (_I, [_P, _P, _P, _P, _I, _L, _P]),
    "reorth_error_string": (ctypes.c_char_p, [_I]),
}


def _check_cuda(basis, w, **small):
    if basis.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got the basis "
                         f"on {basis.device} (ops.reorthogonalize sends CPU "
                         "tensors to the plain version)")
    if basis.dim() != 3 or basis.shape[-1] != LANE:
        raise ValueError(f"basis must be (M, T, {LANE}), got "
                         f"{tuple(basis.shape)}")
    M, T, _ = basis.shape
    if not 1 <= M <= MAX_VECTORS:
        raise ValueError(f"M={M}: the kernels take 1 to {MAX_VECTORS} basis "
                         "vectors")
    if tuple(w.shape) != (T, LANE):
        raise ValueError(f"w must be ({T}, {LANE}), got {tuple(w.shape)}")
    for name, t in {"basis": basis, "w": w, **small}.items():
        if t.device != basis.device:
            raise ValueError(f"{name} must be on {basis.device}, got "
                             f"{t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("basis", basis), ("w", w)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernels "
                             "load float4)")
    for name, t in small.items():
        if tuple(t.shape) != (M,):
            raise ValueError(f"{name} must be ({M},), got {tuple(t.shape)}")
    return M, T


def _raise_on(lib, err, what):
    if err:
        msg = lib.reorth_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} (cudaError {err})")


def reorth_dots(basis, w, mask):
    """basis (M, T, 128), w (T, 128), mask (M,), float32 on one CUDA
    device.  Returns the (M,) dots <v_k, w> times ``mask``."""
    M, T = _check_cuda(basis, w, mask=mask)
    lib = load_library(SOURCE, SIGNATURES)
    elems = T * LANE
    partial = torch.empty((M, lib.reorth_dots_blocks(elems)),
                          dtype=torch.float32, device=w.device)
    dots = torch.empty((M,), dtype=torch.float32, device=w.device)
    with torch.cuda.device(w.device):
        err = lib.reorth_dots_f32(
            basis.data_ptr(), w.data_ptr(), partial.data_ptr(),
            mask.data_ptr(), dots.data_ptr(), M, elems,
            torch.cuda.current_stream(w.device).cuda_stream)
    _raise_on(lib, err, "reorth_dots")
    reorth_dots.launches += 1
    return dots


def reorth_axpy(w, basis, dots, out=None):
    """w (T, 128), basis (M, T, 128), dots (M,), float32 on one CUDA
    device.  Returns ``out`` = w - sum_k dots_k v_k (fresh when None; may
    be ``w`` itself, never overlapping the basis)."""
    M, T = _check_cuda(basis, w, dots=dots)
    if out is None:
        out = torch.empty_like(w)
    _check_cuda(basis, out)
    if overlaps(out, basis) or overlaps(out, dots):
        raise ValueError("out overlaps the basis or the dots: the axpy "
                         "writes in place only into w")
    if out.data_ptr() != w.data_ptr() and overlaps(out, w):
        raise ValueError("out overlaps w without being w")
    lib = load_library(SOURCE, SIGNATURES)
    with torch.cuda.device(w.device):
        err = lib.reorth_axpy_f32(
            w.data_ptr(), basis.data_ptr(), dots.data_ptr(), out.data_ptr(),
            M, T * LANE, torch.cuda.current_stream(w.device).cuda_stream)
    _raise_on(lib, err, "reorth_axpy")
    reorth_axpy.launches += 1
    return out


reorth_dots.launches = 0
reorth_axpy.launches = 0
