"""Shared neural building blocks — the port of ``repro/models/layers.py``
(init helpers, RMSNorm, softcap, SwiGLU, RoPE and qwen2-vl's M-RoPE,
cross-entropy)."""
from __future__ import annotations

import functools
import itertools
import math

import torch


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


@functools.lru_cache(maxsize=None)
def weak_scalar(s: float, dtype) -> float:
    """The Python float ``s`` rounded to ``dtype``: the factor the
    reference's arithmetic uses when it scales an array by a Python float
    (JAX's weak typing casts the scalar to the array's dtype first;
    ``sqrt(4608)`` is 68.0 in bfloat16, not 67.88).  Cached: a step asks
    for the same few factors every call, and each miss reads a host
    tensor back."""
    return torch.tensor(s, dtype=dtype).item()


# ---------------------------------------------------------------------------
# init helpers (weights in the reference's (d_in, d_out) orientation)
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               scale: float | None = None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device)
    return (scale * w).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, device=gen.device)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms / activations
# ---------------------------------------------------------------------------

def rms_norm(x, scale, eps: float = 1e-6):
    """RMSNorm with the ``1 + scale`` gain (zero-initialised scale)."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(dt)


def softcap(x, cap: float):
    """gemma2 logit soft-capping: cap * tanh(x / cap)."""
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


def swiglu(x, w1, w3, w2):
    return (torch.nn.functional.silu(x @ w1) * (x @ w3)) @ w2


# ---------------------------------------------------------------------------
# RoPE / M-RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return theta ** (-torch.arange(0, head_dim, 2, dtype=torch.float32,
                                   device=device) / head_dim)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S) integers.
    Half-split rotation: the first and second halves of the head dim form
    the pairs (not interleaved even/odd lanes)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # (hd/2,)
    angles = positions.float()[..., None] * freqs            # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                    # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x, positions3, theta: float, sections):
    """qwen2-vl M-RoPE.  x: (..., S, H, hd); positions3: (3, ..., S) = the
    (t, h, w) ids.  The hd/2 frequencies are split into ``sections``
    (pair counts, summing to hd/2): frequency i rotates by the id of its
    section, the rotation otherwise ``apply_rope``'s."""
    hd = x.shape[-1]
    half = hd // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to "
                         f"head_dim / 2 = {half}")
    freqs = rope_freqs(hd, theta, x.device)                  # (half,)
    # frequency i's section: how many section ends lie at or below i
    # (built on the device from host ints: no copy, no sync)
    idx = torch.arange(half, device=x.device)
    sec_ids = torch.zeros_like(idx)
    for end in itertools.accumulate(sections[:-1]):
        sec_ids += idx >= end
    p = torch.movedim(positions3, 0, -1)                     # (..., S, 3)
    angles = p[..., sec_ids].float() * freqs                 # (..., S, half)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def cross_entropy(logits, labels, mask=None, logical_vocab: int | None = None):
    """Masked mean token cross-entropy in float32; the padded vocab tail
    (columns from ``logical_vocab`` on) is set to the dtype's lowest value
    first, so it takes no probability."""
    if logical_vocab is not None and logical_vocab < logits.shape[-1]:
        pad = torch.arange(logits.shape[-1],
                           device=logits.device) >= logical_vocab
        logits = logits.masked_fill(pad, torch.finfo(logits.dtype).min)
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        return torch.mean(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
