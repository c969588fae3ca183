"""Hand-written CUDA kernels: batched fused gossip mix + momentum SGD on the
persistent (n, T, 128) parameter store, and its single-learner form.

Port of ``repro/kernels/gossip_mix.py::gossip_mix_update_flat`` (the
Pallas TPU kernel) to CUDA C++ for Hopper; the source and its design note
are in ``csrc/gossip_mix.cu``.  The wrapper takes CUDA tensors only —
``kernels.ops.flat_gossip_update`` sends CPU tensors to the plain version
in ``kernels.ref`` — and checks devices, dtypes (float32 data, int32
partners), contiguity, 16-byte alignment, shapes and that the outputs
overlap no input, before launching on the current stream.

Unlike ``pallas_call``, which always returns fresh buffers, the kernel
writes where it is told: ``out`` (and ``buffer_out`` in publish mode) must
be other buffers than the inputs — the trainer ping-pongs between two —
while the momentum is updated in place.

``gossip_mix_update`` is the single-learner fused mix + momentum + apply
on one (T, 128) buffer with an explicit (K, T, 128) neighbour stack — the
port of ``repro/kernels/gossip_mix.py::gossip_mix_update``, which
``ops.dpsgd_fused_update`` reaches.  It returns fresh outputs, as
``pallas_call`` does.

Each wrapper's ``.launches`` counts its launches (a plain integer, reset
by whoever wants to count a run).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..cuda_build import load_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "gossip_mix.cu"
MAX_NEIGHBORS = 16          # covers every make_schedule table for n <= 16

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
SIGNATURES = {
    "gossip_mix_update_flat_f32": (
        ctypes.c_int,
        [_P, _P, _P, _P, _P,     # w remote grads mu buffer
         _P, _P, _P, _P,         # partners coefs w_out buf_out
         _I, _L, _I,             # n elems K
         _F, _F, _F, _P]),       # lr beta wd stream
    "gossip_mix_update_f32": (
        ctypes.c_int,
        [_P, _P, _P, _P, _P,     # w nbrs grads mu coefs
         _P, _P, _L, _I,         # w_out mu_out elems K
         _F, _F, _P]),           # lr beta stream
    "gossip_mix_error_string": (ctypes.c_char_p, [_I]),
}


def _span(t: torch.Tensor):
    start = t.data_ptr()
    return start, start + t.numel() * t.element_size()


def overlaps(a: torch.Tensor, b: torch.Tensor) -> bool:
    """True when two tensors' memory ranges intersect."""
    (a0, a1), (b0, b1) = _span(a), _span(b)
    return a.device == b.device and a0 < b1 and b0 < a1


def check_outputs(inputs, outputs):
    """Raise when an output buffer shares memory with an input: blocks run
    in no order, so a row written early could be read late."""
    outputs = {k: v for k, v in outputs.items() if v is not None}
    inputs = {k: v for k, v in inputs.items() if v is not None}
    names = list(outputs)
    for j, oname in enumerate(names):
        o = outputs[oname]
        for iname, t in {**inputs, **{m: outputs[m] for m in names[:j]}
                         }.items():
            if overlaps(o, t):
                raise ValueError(
                    f"{oname} overlaps {iname}: the gossip update writes "
                    "w' (and buffer') to other buffers than its inputs")


def _check(w, remote, grads, mu, buffer, partners, coefs, out, buffer_out):
    if w.dim() != 3 or w.shape[-1] != 128:
        raise ValueError(f"w must be (n, T, 128), got {tuple(w.shape)}")
    # the partner ids are trusted, so the remote stack must hold every row
    # they may name: w's n rows, or any R >= 1 at n = 1 (the launch path)
    n = w.shape[0]
    if remote.dim() != 3 or remote.shape[1:] != w.shape[1:] \
            or remote.shape[0] < 1 or (n != 1 and remote.shape[0] != n):
        raise ValueError(f"remote must be ({n}, {w.shape[1]}, 128), or "
                         f"(R >= 1, {w.shape[1]}, 128) at n = 1; got "
                         f"{tuple(remote.shape)}")
    if w.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got w on "
                         f"{w.device} (ops.flat_gossip_update sends CPU "
                         "tensors to the plain version)")
    data = {"w": w, "remote": remote, "grads": grads, "momentum": mu,
            "buffer": buffer, "out": out, "buffer_out": buffer_out}
    data = {k: v for k, v in data.items() if v is not None}
    for name, t in {**data, "partners": partners, "coefs": coefs}.items():
        if t.device != w.device:
            raise ValueError(f"{name} must be on {w.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in data.items():
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if name != "remote" and t.shape != w.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, w "
                             f"{tuple(w.shape)}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel "
                             "loads float4)")
    if partners.dtype != torch.int32 or partners.dim() != 2 \
            or partners.shape[1] != n:
        raise ValueError(f"partners must be (K, {n}) int32, got "
                         f"{tuple(partners.shape)} {partners.dtype}")
    K = partners.shape[0]
    if not 1 <= K <= MAX_NEIGHBORS:
        raise ValueError(f"K={K}: the kernel takes 1 to {MAX_NEIGHBORS} "
                         "neighbours")
    ncoef = K + (5 if buffer is not None else 3)
    if buffer is not None and K != 1:
        raise ValueError("publish mode is pairwise (AD-PSGD): K must be 1")
    if coefs.dtype != torch.float32 or tuple(coefs.shape) != (n, ncoef):
        raise ValueError(f"coefs must be ({n}, {ncoef}) float32, got "
                         f"{tuple(coefs.shape)} {coefs.dtype}")
    check_outputs({"w": w, "remote": remote, "grads": grads, "momentum": mu,
                   "buffer": buffer},
                  {"out": out, "buffer_out": buffer_out})


def gossip_mix_update_flat(w, remote, grads, momentum, partners, coefs, *,
                           lr: float, beta: float = 0.0,
                           weight_decay: float = 0.0,
                           has_momentum: bool = True, buffer=None,
                           out=None, buffer_out=None):
    """w, grads, momentum, buffer: (n, T, 128) float32 on one CUDA device;
    remote: (R, T, 128) float32, the rows the partner ids index — ``w``
    itself (R = n) on one device, or, at n = 1 only, the K rows a rank
    received from its neighbours (R = K) on the launch path; partners
    (K, n) int32 with ids in [0, R) (trusted: checking them would need a
    host sync; a stale read in publish mode takes ``buffer[partner]``, so
    there they lie in [0, n) too); coefs (n, K + 3), or (n, K + 5) in
    publish mode (``buffer`` given, K = 1).

    Returns (w_new, momentum[, buffer_new]): ``w_new`` is ``out`` (fresh
    when None), ``momentum`` is updated in place (untouched when
    ``has_momentum`` is False), ``buffer_new`` is ``buffer_out``."""
    mu = momentum if has_momentum else None
    if out is None:
        out = torch.empty_like(w)
    if buffer is not None and buffer_out is None:
        buffer_out = torch.empty_like(buffer)
    _check(w, remote, grads, mu, buffer, partners, coefs, out, buffer_out)
    lib = load_library(SOURCE, SIGNATURES)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(w.device):
        err = lib.gossip_mix_update_flat_f32(
            w.data_ptr(), remote.data_ptr(), grads.data_ptr(), ptr(mu),
            ptr(buffer), partners.data_ptr(), coefs.data_ptr(),
            out.data_ptr(), ptr(buffer_out), w.shape[0],
            w.shape[1] * w.shape[2], partners.shape[0], float(lr),
            float(beta), float(weight_decay),
            torch.cuda.current_stream(w.device).cuda_stream)
    if err:
        msg = lib.gossip_mix_error_string(err).decode()
        raise RuntimeError(f"gossip_mix_update_flat launch failed: {msg} "
                           f"(cudaError {err})")
    gossip_mix_update_flat.launches += 1
    if buffer is not None:
        return out, momentum, buffer_out
    return out, momentum


gossip_mix_update_flat.launches = 0


def _check_single(w, neighbors, grads, momentum, coefs):
    if w.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got w on "
                         f"{w.device} (ops.gossip_mix_update sends CPU "
                         "tensors to the plain version)")
    if w.dim() != 2 or w.shape[-1] != 128:
        raise ValueError(f"w must be (T, 128), got {tuple(w.shape)}")
    data = {"w": w, "grads": grads, "momentum": momentum,
            "neighbors": neighbors}
    for name, t in {**data, "coefs": coefs}.items():
        if t.device != w.device:
            raise ValueError(f"{name} must be on {w.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
    for name, t in data.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel "
                             "loads float4)")
    for name in ("grads", "momentum"):
        if data[name].shape != w.shape:
            raise ValueError(f"{name} has shape {tuple(data[name].shape)}, "
                             f"w {tuple(w.shape)}")
    if neighbors.dim() != 3 or neighbors.shape[1:] != w.shape:
        raise ValueError(f"neighbors must be (K, {w.shape[0]}, 128), got "
                         f"{tuple(neighbors.shape)}")
    K = neighbors.shape[0]
    if not 1 <= K <= MAX_NEIGHBORS:
        raise ValueError(f"K={K}: the kernel takes 1 to {MAX_NEIGHBORS} "
                         "neighbours")
    if tuple(coefs.shape) != (1 + K,):
        raise ValueError(f"coefs must be ({1 + K},), got "
                         f"{tuple(coefs.shape)}")


def gossip_mix_update(w, neighbors, grads, momentum, coefs, *, lr: float,
                      beta: float = 0.9):
    """w, grads, momentum: (T, 128) float32; neighbors: (K, T, 128);
    coefs: (1 + K,) float32 ``[self, nbr...]``, all on one CUDA device.
    Returns fresh (w_new, mu_new)."""
    _check_single(w, neighbors, grads, momentum, coefs)
    w_out, mu_out = torch.empty_like(w), torch.empty_like(momentum)
    lib = load_library(SOURCE, SIGNATURES)
    with torch.cuda.device(w.device):
        err = lib.gossip_mix_update_f32(
            w.data_ptr(), neighbors.data_ptr(), grads.data_ptr(),
            momentum.data_ptr(), coefs.data_ptr(), w_out.data_ptr(),
            mu_out.data_ptr(), w.numel(), neighbors.shape[0], float(lr),
            float(beta), torch.cuda.current_stream(w.device).cuda_stream)
    if err:
        msg = lib.gossip_mix_error_string(err).decode()
        raise RuntimeError(f"gossip_mix_update launch failed: {msg} "
                           f"(cudaError {err})")
    gossip_mix_update.launches += 1
    return w_out, mu_out


gossip_mix_update.launches = 0
