"""Plain PyTorch versions of the port's kernels (the allclose ground truth).

Each function here computes what its kernel computes, on any device, with
no kernel launch.  The ``ops`` dispatcher takes them for CPU tensors; the
tests and ``chip_smoke.py`` hold the kernels against them on the card.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def paged_decode_attention_ref(q, k_pages, v_pages, page_table, lengths, *,
                               window: int = 0, attn_softcap: float = 0.0):
    """Same contract as ``kernels.ops.paged_decode_attention``.

    q: (S, H, hd) one query token per slot; k_pages, v_pages:
    (P, page, KV, hd) shared page pools; page_table: (S, max_pages) int32
    physical page ids in logical order; lengths: (S,) int32 valid tokens
    per slot (current one included).  Gathers each slot's logical
    (W = max_pages * page) K/V buffer through its table row, masks by
    length (and the trailing ``window`` when set), softmaxes and sums in
    float32 — the chain of ``repro.kernels.ref.paged_decode_attention_ref``.
    A length-0 slot comes out as a uniform average over its masked row:
    finite filler the scheduler never reads.
    """
    S, H, hd = q.shape
    _, page, KV, _ = k_pages.shape
    G = H // KV
    W = page_table.shape[1] * page
    idx = page_table.long()
    kc = k_pages[idx].reshape(S, W, KV, hd)
    vc = v_pages[idx].reshape(S, W, KV, hd)
    qg = q.reshape(S, KV, G, hd)
    s = torch.einsum("bkgd,bwkd->bkgw", qg.float(), kc.float()) * hd ** -0.5
    if attn_softcap:
        s = attn_softcap * torch.tanh(s / attn_softcap)
    kpos = torch.arange(W, device=q.device)[None, :]
    ln = lengths.long()[:, None]
    valid = kpos < ln
    if window:
        valid &= kpos >= ln - window
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgw,bwkd->bkgd", p, vc.float())
    return o.reshape(S, H, hd).to(q.dtype)
