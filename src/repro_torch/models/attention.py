"""Attention for the serving path: GQA projections and paged decode.

Port of the paged half of ``repro/models/attention.py``
(``init_attn_params``, ``init_paged_attn_cache``, ``attn_decode_paged``).
Weights keep the reference's (d_in, d_out) orientation and the layer
computes ``x @ w``, so the arithmetic matches the reference's.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ..kernels.ops import paged_decode_attention
from .layers import dense_init


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
