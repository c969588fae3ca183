"""Hand-written CUDA kernel: blocked flash attention forward (causal /
sliding window / logit softcap, GQA) for training and prefill.

Port of ``repro/kernels/flash_attention.py::flash_attention_fwd`` (the
Pallas TPU kernel) to CUDA C++ for Hopper; the source and its design note
are in ``csrc/flash_attention.cu``.  The wrapper takes CUDA tensors only —
``kernels.ops.flash_attention`` sends CPU tensors to the plain version in
``kernels.ref`` — and checks device, dtype (float32 or bf16, one for all
three), shapes, layout and alignment before launching on the current
stream.

Two kernels in one source, chosen statically by (dtype, hd)
(``kernel_for``): bf16 at hd 64 or 128 runs the tensor-core kernel
(``wgmma``: q.k and P.V in bf16, P as hi + lo, float32 sums); float32 at
any hd, and bf16 at hd 32, run the float32 kernel (q.k in float32 FMAs,
P.V on the tensor cores with P and V each in two TF32 terms).  Both mask
their ragged tiles and so take every Sq and Sk >= 1 — every length the
reference takes.

Layout: q (B, H, Sq, hd), k and v (B, KV, Sk, hd), as the reference's
kernel takes them.  Each may be a strided view — the model's (B, S, H, hd)
tensors ``transpose(1, 2)``-ed — as long as the head dim is contiguous and
the pointer and every other stride are 16-byte aligned: the kernel reads
through the strides, so the dispatcher makes no transposed copies.  The
output takes q's strides.

``flash_attention_fwd.launches`` counts launches (a plain integer, reset
by whoever wants to count a run).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..cuda_build import load_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
HEAD_DIMS = (32, 64, 128)
TC_HEAD_DIMS = (64, 128)     # the tensor-core kernel's, for bf16 inputs
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "flash_attention_fwd": (
        ctypes.c_int,
        [_P, _P, _P, _P,                # q k v out
         _I, _I, _I, _I, _I, _I, _I,    # dtype B H KV Sq Sk hd
         _P,                            # 12 int64 strides
         _I, _I, _F, _F, _P]),          # causal window softcap scale stream
    "flash_attention_fwd_tc": (
        ctypes.c_int,
        [_P, _P, _P, _P,                # q k v out
         _I, _I, _I, _I, _I, _I,        # B H KV Sq Sk hd
         _P,                            # 12 int64 strides
         _I, _I, _F, _F, _P]),          # causal window softcap scale stream
    "flash_attention_error_string": (ctypes.c_char_p, [_I]),
}


def kernel_for(dtype, hd: int) -> str:
    """Which kernel runs (dtype, hd): ``"tc"`` (``wgmma`` in bf16) for bf16
    at hd 64 or 128, ``"mma"`` (float32 FMA scores, 3xTF32 ``mma.sync``
    P.V) otherwise.  Static: never a fallback."""
    return "tc" if dtype == torch.bfloat16 and hd in TC_HEAD_DIMS else "mma"


def check_shapes(q_shape, k_shape, v_shape, dtype):
    """The shape rule of ``flash_attention_fwd`` for q (B, H, Sq, hd) and
    k, v (B, KV, Sk, hd): raises ValueError on what neither kernel takes.
    Returns the kernel that takes it (``kernel_for``)."""
    if len(q_shape) != 4 or len(k_shape) != 4:
        raise ValueError(f"q and k must be 4-d, got {tuple(q_shape)}, "
                         f"{tuple(k_shape)}")
    B, H, Sq, hd = q_shape
    _, KV, Sk, _ = k_shape
    if k_shape[0] != B or k_shape[3] != hd or tuple(v_shape) != \
            tuple(k_shape):
        raise ValueError(f"k {tuple(k_shape)} / v {tuple(v_shape)} do not "
                         f"fit q {tuple(q_shape)}")
    if KV < 1 or H % KV:
        raise ValueError(f"H={H}, KV={KV}: need H % KV == 0")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd}: the kernel takes {HEAD_DIMS}")
    if Sq < 1 or Sk < 1:
        raise ValueError(f"Sq={Sq}, Sk={Sk}: need at least one row each")
    return kernel_for(dtype, hd)


def _check(q, k, v):
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got q on "
                         f"{q.device} (ops.flash_attention sends CPU tensors "
                         "to the plain version)")
    tensors = {"q": q, "k": k, "v": v}
    if q.dtype not in DTYPES:
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} must be on {q.device}, got {t.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q {q.dtype}: the kernel "
                             "takes one dtype")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-d, got {tuple(t.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous (stride "
                             f"1), got strides {t.stride()}")
        if t.data_ptr() % 16 or any(
                (s * t.element_size()) % 16 for s in t.stride()[:3]):
            raise ValueError(f"{name} must be 16-byte aligned with 16-byte "
                             f"strides (the kernel loads 16-byte rows), got "
                             f"strides {t.stride()}")
    return check_shapes(q.shape, k.shape, v.shape, q.dtype)


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0,
                        attn_softcap: float = 0.0):
    """q: (B, H, Sq, hd); k, v: (B, KV, Sk, hd) -> (B, H, Sq, hd) in q's
    dtype and strides, on one CUDA device.  Positions are contiguous from
    0 (training / prefill)."""
    route = _check(q, k, v)
    B, H, Sq, hd = q.shape
    _, KV, Sk, _ = k.shape
    out = torch.empty_like(q)              # q's strides (preserve_format)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3])
    lib = load_library(SOURCE, SIGNATURES)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    tail = (ctypes.cast(strides, ctypes.c_void_p), int(bool(causal)),
            int(window), float(attn_softcap), hd ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    with torch.cuda.device(q.device):
        if route == "tc":
            err = lib.flash_attention_fwd_tc(*ptrs, B, H, KV, Sq, Sk, hd,
                                             *tail)
        else:
            err = lib.flash_attention_fwd(*ptrs, DTYPES[q.dtype], B, H, KV,
                                          Sq, Sk, hd, *tail)
    if err:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention launch failed: {msg} "
                           f"(cudaError {err})")
    flash_attention_fwd.launches += 1
    return out


flash_attention_fwd.launches = 0
