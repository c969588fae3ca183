"""Attention: GQA projections, chunked or flash attention for
training/prefill, and paged decode for serving.

Port of ``repro/models/attention.py`` (``init_attn_params``,
``chunked_attention``, ``attn_forward``, ``init_attn_cache``,
``attn_decode``, ``init_paged_attn_cache``, ``attn_decode_paged``), and
the sequence-sharded decode (``attn_decode_sharded``, ``merge_partials``:
a rank holds a slice of the buffer's time dim, and only the softmax's
float32 partials cross ranks).
Weights keep the reference's (d_in, d_out) orientation and the layer
computes ``x @ w``, so the arithmetic matches the reference's.
``attn_forward`` takes cross-attention (``kv_input``) and M-RoPE
positions; with ``use_pallas=True`` it routes the core of a plain
self-attention to ``kernels.ops.flash_attention`` (the hand-written flash
kernel on the card).  ``rope_fn=None`` (a model without RoPE, e.g. jamba) skips the
rotation everywhere.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ..kernels.ops import flash_attention, paged_decode_attention
from .layers import dense_init, softcap

NEG_INF = -1e30


class AttnParams(nn.Module):
    """wq (d, H*hd), wk/wv (d, KV*hd), wo (H*hd, d)."""

    def __init__(self, wq, wk, wv, wo):
        super().__init__()
        self.wq = nn.Parameter(wq)
        self.wk = nn.Parameter(wk)
        self.wv = nn.Parameter(wv)
        self.wo = nn.Parameter(wo)


def init_attn_params(gen: torch.Generator, d_model: int, n_heads: int,
                     n_kv: int, head_dim: int, dtype) -> AttnParams:
    return AttnParams(
        dense_init(gen, d_model, n_heads * head_dim, dtype),
        dense_init(gen, d_model, n_kv * head_dim, dtype),
        dense_init(gen, d_model, n_kv * head_dim, dtype),
        dense_init(gen, n_heads * head_dim, d_model, dtype))


# ---------------------------------------------------------------------------
# chunked attention core (training / prefill)
# ---------------------------------------------------------------------------

def chunked_attention(q, k, v, *, q_positions, k_positions,
                      causal: bool = True, window: int = 0,
                      attn_softcap: float = 0.0, chunk: int = 1024):
    """q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd); positions: (Sq,), (Sk,).

    Returns (B, Sq, H, hd).  Blocked over both q and k with an online
    softmax in float32, the reference's loop written out.  The reference
    rematerializes each q block in the backward pass (``jax.checkpoint``);
    here autograd keeps the blocks' activations, which at the training
    shapes of this slice (S = 512, chunk 256) is a few MB per layer.
    """
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    G = H // KV
    cq, ck = min(chunk, Sq), min(chunk, Sk)
    if Sq % cq or Sk % ck:
        raise ValueError(f"sequence lengths {Sq}, {Sk} are not multiples of "
                         f"the attention chunk {chunk}")
    nq, nk = Sq // cq, Sk // ck
    scale = hd ** -0.5
    qs = q.reshape(B, nq, cq, KV, G, hd)
    ks = k.reshape(B, nk, ck, KV, hd)
    vs = v.reshape(B, nk, ck, KV, hd)
    outs = []
    for iq in range(nq):
        qb = qs[:, iq].float()
        qpb = q_positions[iq * cq:(iq + 1) * cq]
        m = torch.full((B, KV, G, cq), NEG_INF, device=q.device)
        lsum = torch.zeros((B, KV, G, cq), device=q.device)
        acc = torch.zeros((B, cq, KV, G, hd), device=q.device)
        for ik in range(nk):
            kpb = k_positions[ik * ck:(ik + 1) * ck]
            s = torch.einsum("bqkgd,bckd->bkgqc", qb,
                             ks[:, ik].float()) * scale
            if attn_softcap:
                s = softcap(s, attn_softcap)
            mask = torch.ones((cq, ck), dtype=torch.bool, device=q.device)
            if causal:
                mask &= qpb[:, None] >= kpb[None, :]
            if window:
                mask &= qpb[:, None] - kpb[None, :] < window
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            lsum = lsum * corr + torch.sum(p, dim=-1)
            pv = torch.einsum("bkgqc,bckd->bqkgd", p, vs[:, ik].float())
            acc = acc * corr.permute(0, 3, 1, 2)[..., None] + pv
            m = m_new
        outs.append(acc / torch.clamp(lsum, min=1e-30).permute(0, 3, 1, 2)
                    [..., None])
    out = torch.cat(outs, dim=1).reshape(B, Sq, H, hd)
    return out.to(q.dtype)


def attn_forward(params: AttnParams, x, *, n_heads: int, n_kv: int,
                 head_dim: int, rope_fn: Optional[Callable], q_positions,
                 k_positions=None, window: int = 0,
                 attn_softcap: float = 0.0, chunk: int = 1024,
                 kv_input=None, causal: bool = True,
                 use_pallas: bool = False, mask_positions=None):
    """Attention layer forward.  x: (B, S, d); ``kv_input``: the memory of
    a cross-attention (B, Sk, d), or None for self-attention.

    ``q_positions`` feed the rope_fn (they may be (3, S) under M-RoPE);
    ``mask_positions`` (default: q_positions) are the scalar (S,) ids of
    the causal/window mask.  Keys rotate by ``k_positions``, else by
    q_positions (self-attention) or by 0..Sk-1 (cross-attention), at which
    cross-attention keys are also masked.  ``use_pallas`` sends the core
    to ``ops.flash_attention``, which takes self-attention at positions
    contiguous from 0; otherwise ``chunked_attention``."""
    if use_pallas and (kv_input is not None or mask_positions is not None):
        raise ValueError(
            "use_pallas: the flash route takes self-attention at positions "
            "contiguous from 0, not cross-attention (kv_input) or separate "
            "mask positions (M-RoPE); the reference's flash route raises "
            "for these configurations too (its position arrays pass "
            "custom_vjp's nondiff_argnums as tracers)")
    B, S, _ = x.shape
    kv_src = x if kv_input is None else kv_input
    Sk = kv_src.shape[1]
    if mask_positions is None:
        mask_positions = q_positions
    k_mask = (mask_positions if kv_input is None
              else torch.arange(Sk, device=x.device))
    q = (x @ params.wq).reshape(B, S, n_heads, head_dim)
    k = (kv_src @ params.wk).reshape(B, Sk, n_kv, head_dim)
    v = (kv_src @ params.wv).reshape(B, Sk, n_kv, head_dim)
    if rope_fn is not None:
        q = rope_fn(q, q_positions)
        k = rope_fn(k, k_positions if k_positions is not None
                    else (q_positions if kv_input is None else k_mask))
    if use_pallas:
        out = flash_attention(q, k, v, q_positions=mask_positions,
                              k_positions=k_mask, causal=causal,
                              window=window, attn_softcap=attn_softcap)
    else:
        out = chunked_attention(q, k, v, q_positions=mask_positions,
                                k_positions=k_mask, causal=causal,
                                window=window, attn_softcap=attn_softcap,
                                chunk=chunk)
    return out.reshape(B, S, n_heads * head_dim) @ params.wo


# ---------------------------------------------------------------------------
# decode: one new token against a rotating K/V buffer
# ---------------------------------------------------------------------------

def init_attn_cache(batch: int, buf_len: int, n_kv: int, head_dim: int,
                    dtype, device):
    """A rotating K/V buffer of ``buf_len`` positions; ``slot_pos`` holds
    the position each buffer row was written at (-1: empty)."""
    shape = (batch, buf_len, n_kv, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "slot_pos": torch.full((buf_len,), -1, dtype=torch.int32,
                                   device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attn_decode(params: AttnParams, cache, x, pos: int, *, n_heads: int,
                n_kv: int, head_dim: int, rope_fn: Optional[Callable],
                attn_softcap: float = 0.0):
    """x: (B, 1, d); pos: the position every sequence writes at.  Row
    ``pos % buf_len`` of the buffer is written IN PLACE and the returned
    cache is the same tensors.  Returns (out (B, 1, d), cache)."""
    B = x.shape[0]
    buf = cache["k"].shape[1]
    q = (x @ params.wq).reshape(B, 1, n_heads, head_dim)
    k = (x @ params.wk).reshape(B, 1, n_kv, head_dim)
    v = (x @ params.wv).reshape(B, 1, n_kv, head_dim)
    if rope_fn is not None:
        posv = torch.full((1,), pos, dtype=torch.int32, device=x.device)
        q = rope_fn(q, posv)
        k = rope_fn(k, posv)

    slot = pos % buf
    kc, vc, sp = cache["k"], cache["v"], cache["slot_pos"]
    kc[:, slot] = k[:, 0].to(kc.dtype)
    vc[:, slot] = v[:, 0].to(vc.dtype)
    sp[slot] = pos

    G = n_heads // n_kv
    qg = q.reshape(B, n_kv, G, head_dim)
    s = torch.einsum("bkgd,bwkd->bkgw", qg.float(),
                     kc.float()) * head_dim ** -0.5
    if attn_softcap:
        s = softcap(s, attn_softcap)
    valid = (sp >= 0) & (sp <= pos)
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgw,bwkd->bkgd", p, vc.float())
    out = o.reshape(B, 1, n_heads * head_dim).to(x.dtype) @ params.wo
    return out, cache


def attn_decode_sharded(params: AttnParams, cache, x, pos: int, *,
                        n_heads: int, n_kv: int, head_dim: int,
                        rope_fn: Optional[Callable], attn_softcap: float,
                        rank: int, size: int, merge: Callable):
    """``attn_decode`` with the buffer's time dim W cut over ``size``
    ranks: ``cache["k"]`` / ``["v"]`` are this rank's (B, W / size, KV,
    hd) slice (rows [rank W/size, (rank + 1) W/size) of the rotating
    buffer), ``cache["slot_pos"]`` the whole (W,) table.  The new K/V row
    lands on the rank whose slice holds row ``pos % W``; every rank writes
    ``slot_pos``.  The rank's scores over its rows (softcap before the
    mask, as ``attn_decode``) give float32 partials: the row max m, the
    sum l of exp(s - m) over its live rows and the unnormalized output o;
    ``merge(m, l, o)`` combines the ranks' partials (``merge_partials``
    over a gather of them) into the (B, KV, G, hd) output.  A slice with
    no live row yet has m = NEG_INF and l = 0, o = 0: it adds nothing.
    Returns (out (B, 1, d), cache)."""
    B = x.shape[0]
    kc, vc, sp = cache["k"], cache["v"], cache["slot_pos"]
    w_loc, buf = kc.shape[1], sp.shape[0]
    q = (x @ params.wq).reshape(B, 1, n_heads, head_dim)
    k = (x @ params.wk).reshape(B, 1, n_kv, head_dim)
    v = (x @ params.wv).reshape(B, 1, n_kv, head_dim)
    if rope_fn is not None:
        posv = torch.full((1,), pos, dtype=torch.int32, device=x.device)
        q = rope_fn(q, posv)
        k = rope_fn(k, posv)

    slot = pos % buf
    if slot // w_loc == rank:
        kc[:, slot % w_loc] = k[:, 0].to(kc.dtype)
        vc[:, slot % w_loc] = v[:, 0].to(vc.dtype)
    sp[slot] = pos

    G = n_heads // n_kv
    qg = q.reshape(B, n_kv, G, head_dim)
    s = torch.einsum("bkgd,bwkd->bkgw", qg.float(),
                     kc.float()) * head_dim ** -0.5
    if attn_softcap:
        s = softcap(s, attn_softcap)
    mine = sp[rank * w_loc:(rank + 1) * w_loc]
    valid = (mine >= 0) & (mine <= pos)
    s = torch.where(valid, s, NEG_INF)
    m = torch.amax(s, dim=-1)
    p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    o = torch.einsum("bkgw,bwkd->bkgd", p, vc.float())
    out = merge(m, torch.sum(p, dim=-1), o)
    out = out.reshape(B, 1, n_heads * head_dim).to(x.dtype) @ params.wo
    return out, cache


def attn_cross_decode_sharded(params: AttnParams, xk, xv, x, pos: int, *,
                              n_heads: int, n_kv: int, head_dim: int,
                              rope_fn: Optional[Callable], merge: Callable):
    """``encdec.decode_step``'s cross-attention with the encoder length
    cut over ranks: ``xk`` / ``xv`` are this rank's (B, S_enc / size, KV,
    hd) slice of the memory's K/V.  Every memory row is live, so there is
    no mask: the rank's scores give float32 partials (row max m, sum l of
    exp(s - m), unnormalized output o), and ``merge(m, l, o)`` combines
    the ranks' (``merge_partials``) into the (B, KV, G, hd) output.  Over
    one rank it is the einsum softmax of ``decode_step``.  Returns (B, 1,
    d)."""
    B = x.shape[0]
    q = (x @ params.wq).reshape(B, 1, n_heads, head_dim)
    if rope_fn is not None:
        q = rope_fn(q, torch.full((1,), pos, dtype=torch.int32,
                                  device=x.device))
    qg = q.reshape(B, n_kv, n_heads // n_kv, head_dim)
    s = torch.einsum("bkgd,bwkd->bkgw", qg.float(),
                     xk.float()) * head_dim ** -0.5
    m = torch.amax(s, dim=-1)
    p = torch.exp(s - m[..., None])
    o = torch.einsum("bkgw,bwkd->bkgd", p, xv.float())
    out = merge(m, torch.sum(p, dim=-1), o)
    return out.reshape(B, 1, n_heads * head_dim).to(x.dtype) @ params.wo


def merge_partials(parts: torch.Tensor) -> torch.Tensor:
    """The ranks' decode partials, (size, B, KV, G, hd + 2) float32 [o, m,
    l], combined in rank order: sum_r e^(m_r - M) o_r / sum_r e^(m_r - M)
    l_r with M the max of the m_r -- the softmax over the whole buffer.
    A rank with no live row (m_r = NEG_INF, l_r = 0) weighs e^(NEG_INF -
    M) = 0."""
    o, m, lsum = parts[..., :-2], parts[..., -2], parts[..., -1]
    top = torch.amax(m, dim=0)
    num = torch.zeros_like(o[0])
    den = torch.zeros_like(top)
    for r in range(parts.shape[0]):
        w = torch.exp(m[r] - top)
        num = num + w[..., None] * o[r]
        den = den + w * lsum[r]
    return num / torch.clamp(den, min=1e-30)[..., None]


def init_paged_attn_cache(n_pages: int, page_size: int, n_kv: int,
                          head_dim: int, dtype, device):
    """Paged K/V pools for one attention layer (DESIGN §14): no slot axis;
    the scheduler's page table says which pages a slot owns.  Page 0 is the
    scratch page that idle and stalled slots write to."""
    shape = (n_pages, page_size, n_kv, head_dim)
    return {"k_pages": torch.zeros(shape, dtype=dtype, device=device),
            "v_pages": torch.zeros(shape, dtype=dtype, device=device)}


def attn_decode_paged(params: AttnParams, cache, x, positions, page_table, *,
                      n_heads: int, n_kv: int, head_dim: int,
                      rope_fn: Optional[Callable], attn_softcap: float = 0.0,
                      window: int = 0):
    """One new token per slot at per-slot positions.

    x: (S, 1, d); positions: (S,) int32 write positions; page_table:
    (S, max_pages) int32; cache: ``init_paged_attn_cache`` pools.  Returns
    (out (S, 1, d), cache).

    The new K/V rows are written into the pools IN PLACE (the reference
    donates the cache to its jitted step and gets fresh buffers back; here
    the returned cache is the same tensors).  Idle and stalled slots resolve
    to the scratch page 0 and may collide there — harmless, since length
    masks keep scratch from ever being read.
    """
    S = x.shape[0]
    k_pool, v_pool = cache["k_pages"], cache["v_pages"]
    page = k_pool.shape[1]
    q = (x @ params.wq).reshape(S, 1, n_heads, head_dim)
    k = (x @ params.wk).reshape(S, 1, n_kv, head_dim)
    v = (x @ params.wv).reshape(S, 1, n_kv, head_dim)
    if rope_fn is not None:
        q = rope_fn(q, positions[:, None])
        k = rope_fn(k, positions[:, None])

    pos = positions.long()
    ppage = page_table.long().gather(1, (pos // page)[:, None])[:, 0]
    off = pos % page
    k_pool[ppage, off] = k[:, 0].to(k_pool.dtype)
    v_pool[ppage, off] = v[:, 0].to(v_pool.dtype)

    # the kernel takes the int32 table and lengths as they are
    o = paged_decode_attention(q.reshape(S, n_heads, head_dim), k_pool,
                               v_pool, page_table, positions + 1,
                               window=window, attn_softcap=attn_softcap)
    out = o.reshape(S, 1, n_heads * head_dim).to(x.dtype) @ params.wo
    return out, cache
