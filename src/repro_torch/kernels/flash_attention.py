"""Hand-written CUDA kernels: blocked flash attention forward and backward
(causal / sliding window / logit softcap, GQA) for training and prefill.

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
any hd, and bf16 at hd 32 and 256, run the float32 kernel (q.k in float32
FMAs, P.V on the tensor cores with P and V each in two TF32 terms).  Both
mask their ragged tiles and so take every Sq and Sk >= 1 — every length
the reference takes.

Head dims: the kernels are instantiated at ``HEAD_DIMS`` (32, 64, 128,
256); any other hd from 1 to 256 is zero-padded (``pad_head_dim``) to the
next of them, launched with the true hd's scale ``hd ** -0.5``, and the
first hd columns of the output are kept.  The padding is exact: the zero
columns add exact zeros to every q.k, and the output columns they make
are dropped.  The padded copies are contiguous and aligned, so such an hd
takes any layout.  Above 256 the wrapper raises, as no instantiation fits
O's accumulators in registers there.

Layout: q (B, H, Sq, hd), k and v (B, KV, Sk, hd), as the reference's
kernel takes them.  At an instantiated hd each may be a strided view — the
model's (B, S, H, hd) tensors ``transpose(1, 2)``-ed — as long as the head
dim is contiguous and the pointer and every other stride are 16-byte
aligned: the kernel reads through the strides, so the dispatcher makes no
transposed copies.  The output takes q's strides.

``flash_attention_fwd.launches`` counts launches (a plain integer, reset
by whoever wants to count a run).  With ``return_lse=True`` the forward
also writes each row's log-sum-exp, float32 (B, H, Sq): the backward's
row statistic.

The backward, ``flash_attention_bwd`` (``csrc/flash_bwd.cu``, replacing
no TPU kernel: the reference differentiates its oracle), takes q, k, v,
the forward's output and lse, and dO, and returns dq, dk, dv in q's, k's
and v's dtype and strides: a preprocess pass (D = rowsum(dO * o), the
float32 dq accumulator zeroed) and the main kernel (blocked over 128-key
tiles, dq added with float32 atomics).  It takes the forward's contract
at ``BWD_HEAD_DIMS`` (32, 64, 128, and every hd up to 128 zero-padded);
at a padded hd of 256 no instance holds dK and dV in registers, and
``backward_kernel_takes`` says so (the autograd Function keeps the plain
version's recompute there).  ``flash_attention_bwd.launches`` counts its
calls, two launches each.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..cuda_build import load_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
BWD_SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_bwd.cu"
HEAD_DIMS = (32, 64, 128, 256)     # the instantiated head dims
BWD_HEAD_DIMS = (32, 64, 128)      # the backward's
MAX_HEAD_DIM = HEAD_DIMS[-1]
TC_HEAD_DIMS = (64, 128)     # the tensor-core kernel's, for bf16 inputs
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "flash_attention_fwd": (
        ctypes.c_int,
        [_P, _P, _P, _P,                # q k v out
         _I, _I, _I, _I, _I, _I, _I,    # dtype B H KV Sq Sk hd
         _P,                            # 12 int64 strides
         _I, _I, _F, _F, _P, _P]),      # causal window softcap scale lse
                                        # stream
    "flash_attention_fwd_tc": (
        ctypes.c_int,
        [_P, _P, _P, _P,                # q k v out
         _I, _I, _I, _I, _I, _I,        # B H KV Sq Sk hd
         _P,                            # 12 int64 strides
         _I, _I, _F, _F, _P, _P]),      # causal window softcap scale lse
                                        # stream
    "flash_attention_error_string": (ctypes.c_char_p, [_I]),
}
BWD_SIGNATURES = {
    "flash_bwd": (
        ctypes.c_int,
        [_P, _P, _P, _P, _P,            # q k v o dO
         _P, _P, _P, _P, _P,            # lse D dq (float32) dk dv
         _I, _I, _I, _I, _I, _I, _I,    # dtype B H KV Sq Sk hd
         _P,                            # 24 int64 strides
         _I, _I, _F, _F, _P]),          # causal window softcap scale stream
    "flash_bwd_error_string": (ctypes.c_char_p, [_I]),
}


def padded_head_dim(hd: int) -> int:
    """The instantiated head dim that runs ``hd``: the smallest of
    ``HEAD_DIMS`` at or above it.  Raises ValueError outside 1..256."""
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd}: the kernel takes 1 <= hd <= "
                         f"{MAX_HEAD_DIM}")
    return next(d for d in HEAD_DIMS if d >= hd)


def pad_head_dim(q, k, v):
    """q, k, v zero-padded on the head dim to ``padded_head_dim`` (fresh
    contiguous tensors), or the tensors themselves at an instantiated
    hd."""
    hd = q.shape[-1]
    pad = padded_head_dim(hd) - hd
    if not pad:
        return q, k, v
    return tuple(torch.nn.functional.pad(t, (0, pad)) for t in (q, k, v))


def kernel_for(dtype, hd: int) -> str:
    """Which kernel runs (dtype, hd): ``"tc"`` (``wgmma`` in bf16) for bf16
    whose padded hd is 64 or 128, ``"mma"`` (float32 FMA scores, 3xTF32
    ``mma.sync`` P.V) otherwise.  Static: never a fallback."""
    return ("tc" if dtype == torch.bfloat16
            and padded_head_dim(hd) in TC_HEAD_DIMS else "mma")


def backward_kernel_takes(hd: int) -> bool:
    """Whether ``flash_attention_bwd`` runs head dim ``hd``: its padded hd
    is one of ``BWD_HEAD_DIMS`` (at 256, dK and dV would need 256
    registers a thread).  Static, by shape: never a fallback."""
    return padded_head_dim(hd) in BWD_HEAD_DIMS


def check_shapes(q_shape, k_shape, v_shape, dtype):
    """The shape rule of ``flash_attention_fwd`` for q (B, H, Sq, hd) and
    k, v (B, KV, Sk, hd): raises ValueError on what neither kernel takes.
    Returns the kernel that runs it (``kernel_for``)."""
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
    padded_head_dim(hd)
    if Sq < 1 or Sk < 1:
        raise ValueError(f"Sq={Sq}, Sk={Sk}: need at least one row each")
    return kernel_for(dtype, hd)


def _fits(t) -> bool:
    """Head dim contiguous, pointer and other strides 16-byte aligned: the
    kernels read such a view in place."""
    return t.stride(-1) == 1 and not t.data_ptr() % 16 and not any(
        (s * t.element_size()) % 16 for s in t.stride()[:3])


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
        if q.shape[-1] not in HEAD_DIMS:
            continue                   # launched as a padded copy
        if not _fits(t):
            raise ValueError(f"{name}'s head dim must be contiguous (stride "
                             f"1) and it must be 16-byte aligned with "
                             f"16-byte strides (the kernel loads 16-byte "
                             f"rows), got strides {t.stride()}")
    return check_shapes(q.shape, k.shape, v.shape, q.dtype)


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0,
                        attn_softcap: float = 0.0, return_lse: bool = False):
    """q: (B, H, Sq, hd); k, v: (B, KV, Sk, hd) -> (B, H, Sq, hd) in q's
    dtype and strides, on one CUDA device.  Positions are contiguous from
    0 (training / prefill); 1 <= hd <= 256.  ``return_lse``: also each
    row's log-sum-exp, m + log(max(l, 1e-30)) in float32 (B, H, Sq), and
    return (out, lse)."""
    route = _check(q, k, v)
    B, H, Sq, hd = q.shape
    _, KV, Sk, _ = k.shape
    qp, kp, vp = pad_head_dim(q, k, v)
    hp = qp.shape[-1]
    out = torch.empty_like(qp)             # q's strides (preserve_format)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    strides = (ctypes.c_longlong * 12)(
        *qp.stride()[:3], *kp.stride()[:3], *vp.stride()[:3],
        *out.stride()[:3])
    lib = load_library(SOURCE, SIGNATURES)
    ptrs = (qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), out.data_ptr())
    tail = (ctypes.cast(strides, ctypes.c_void_p), int(bool(causal)),
            int(window), float(attn_softcap), hd ** -0.5,
            None if lse is None else lse.data_ptr(),
            torch.cuda.current_stream(q.device).cuda_stream)
    with torch.cuda.device(q.device):
        if route == "tc":
            err = lib.flash_attention_fwd_tc(*ptrs, B, H, KV, Sq, Sk, hp,
                                             *tail)
        else:
            err = lib.flash_attention_fwd(*ptrs, DTYPES[q.dtype], B, H, KV,
                                          Sq, Sk, hp, *tail)
    if err:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention launch failed: {msg} "
                           f"(cudaError {err})")
    flash_attention_fwd.launches += 1
    if hp != hd:                           # the true hd's columns
        out = torch.empty_like(q).copy_(out[..., :hd])
    return (out, lse) if return_lse else out


flash_attention_fwd.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int = 0, attn_softcap: float = 0.0):
    """The gradient of ``flash_attention_fwd``: q (B, H, Sq, hd), k, v (B,
    KV, Sk, hd), the forward's output o and dO (B, H, Sq, hd), and its lse
    (float32 (B, H, Sq)) -> (dq, dk, dv) in q's, k's and v's dtype and
    strides (the model layout where they are its transposed views), on one
    CUDA device.  hd from 1 to 128 (``backward_kernel_takes``); o and dO
    are read in place where their strides fit as q's must (else copied
    contiguous).  dq sums with float32 atomics (its rounding may differ
    from run to run); dk and dv are deterministic."""
    _check(q, k, v)
    B, H, Sq, hd = q.shape
    _, KV, Sk, _ = k.shape
    if not backward_kernel_takes(hd):
        raise ValueError(f"head_dim {hd}: the backward kernel takes 1 <= hd "
                         f"<= {BWD_HEAD_DIMS[-1]}")
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype or o.device != q.device \
            or do.device != q.device:
        raise ValueError(f"o {o.dtype} {tuple(o.shape)} and dO {do.dtype} "
                         f"{tuple(do.shape)} must be q's {q.dtype} "
                         f"{tuple(q.shape)} on {q.device}")
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32 \
            or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"lse must be float32 {(B, H, Sq)} contiguous on "
                         f"{q.device}, got {lse.dtype} {tuple(lse.shape)}")
    qp, kp, vp = pad_head_dim(q, k, v)
    hp = qp.shape[-1]
    if hp != hd:
        o, do = (torch.nn.functional.pad(t, (0, hp - hd)) for t in (o, do))
    o, do = (t if _fits(t) else t.contiguous() for t in (o, do))
    dq = torch.empty_like(qp, dtype=torch.float32)   # the accumulator
    dk, dv = torch.empty_like(kp), torch.empty_like(vp)
    dd = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 24)(*(
        s for t in (qp, kp, vp, o, do, dq, dk, dv) for s in t.stride()[:3]))
    lib = load_library(BWD_SOURCE, BWD_SIGNATURES)
    with torch.cuda.device(q.device):
        err = lib.flash_bwd(
            qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dd.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), DTYPES[q.dtype], B, H, KV, Sq, Sk,
            hp, ctypes.cast(strides, ctypes.c_void_p), int(bool(causal)),
            int(window), float(attn_softcap), hd ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        msg = lib.flash_bwd_error_string(err).decode()
        raise RuntimeError(f"flash_bwd launch failed: {msg} (cudaError "
                           f"{err})")
    flash_attention_bwd.launches += 1
    if dq.dtype != q.dtype:
        dq = dq.to(q.dtype)
    if hp != hd:                           # the true hd's columns
        dq, dk, dv = (torch.empty_like(t).copy_(g[..., :hd])
                      for t, g in ((q, dq), (k, dk), (v, dv)))
    return dq, dk, dv


flash_attention_bwd.launches = 0
