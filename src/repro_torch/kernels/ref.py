"""Plain PyTorch versions of the port's kernels (the allclose ground truth).

Each function here computes what its kernel computes, on any device, with
no kernel launch.  The ``ops`` dispatcher takes them for CPU tensors; the
tests and ``chip_smoke.py`` hold the kernels against them on the card.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def gossip_mix_update_ref(w, neighbors, grads, momentum, coefs, *,
                          lr: float, beta: float = 0.9):
    """Same contract as ``kernels.gossip_mix.gossip_mix_update``: the
    single-learner fused mix + momentum + apply, fresh outputs.

    w, grads, momentum: (T, 128); neighbors: (K, T, 128); coefs: (1 + K,)
    ``[self, nbr...]``.  ``mixed = c0 w + sum_k c_k nbr_k`` (self term
    first, neighbours in order), ``mu' = beta mu + g``, ``w' = mixed - lr
    mu'``, one rounded operation at a time — the arithmetic of
    ``repro.kernels.ref.gossip_mix_update_ref``; the CUDA kernel repeats it
    bitwise.  Returns (w_new, mu_new)."""
    mixed = coefs[0] * w
    for k in range(neighbors.shape[0]):
        mixed = mixed + coefs[k + 1] * neighbors[k]
    mu_new = beta * momentum + grads
    return mixed - lr * mu_new, mu_new


def gossip_mix_update_flat_ref(w, remote, grads, momentum, partners, coefs,
                               *, lr: float, beta: float = 0.0,
                               weight_decay: float = 0.0,
                               has_momentum: bool = True, buffer=None):
    """Same contract as ``kernels.gossip_mix.gossip_mix_update_flat``, with
    fresh outputs: returns (w_new, mu_new[, buffer_new]).

    w, remote, grads, momentum, buffer: (n, T, 128); partners (K, n) int;
    coefs (n, K + 3) ``[self, nbr..., lr scale, active]``, plus
    ``[nbr_fresh, publish]`` in publish mode.  The arithmetic order of
    ``repro.kernels.ref.gossip_mix_update_flat_ref`` (self term first,
    neighbours in schedule order, fused lr scale, ``where`` selects), one
    rounded operation at a time — the CUDA kernel repeats it bitwise.
    With ``lr=0.0`` this is the mixing-only round."""
    K = partners.shape[0]
    publish = buffer is not None
    p = partners.long()

    def col(j):
        return coefs[:, j][:, None, None]

    mixed = col(0) * w
    for k in range(K):
        nbr = remote[p[k]]
        if publish:
            nbr = torch.where(col(3 + K) > 0.5, nbr, buffer[p[k]])
        mixed = mixed + col(1 + k) * nbr
    g = grads
    if weight_decay:
        g = g + weight_decay * w
    lr_eff = lr * col(1 + K)
    active = col(2 + K) > 0.5
    if has_momentum:
        mu_new = beta * momentum + g
        new_w = torch.where(active, mixed - lr_eff * mu_new, w)
        mu_out = torch.where(active, mu_new, momentum)
    else:
        new_w = torch.where(active, mixed - lr_eff * g, w)
        mu_out = momentum
    if publish:
        return new_w, mu_out, torch.where(col(4 + K) > 0.5, new_w, buffer)
    return new_w, mu_out


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


def reorth_axpy_ref(w, basis, dots):
    """Same contract as ``kernels.reorth.reorth_axpy``: w - sum_k d_k v_k,
    k in order, each product and difference rounded on its own (the CUDA
    kernel repeats it bitwise given the same dots)."""
    acc = w.float()
    for k in range(basis.shape[0]):
        acc = acc - dots[k] * basis[k].float()
    return acc.to(w.dtype)


def reorth_dots_ref(basis, w, mask):
    """Same contract as ``kernels.reorth.reorth_dots``: the (M,) dots
    <v_k, w>, one vector at a time, times ``mask``."""
    wf = w.float()
    return torch.stack([torch.sum(basis[k].float() * wf)
                        for k in range(basis.shape[0])]) * mask


def reorth_ref(basis, w, mask):
    """One CGS sweep (``kernels.reorth.reorth_dots`` then ``reorth_axpy``),
    the plain version of ``repro.kernels.ref.reorth_ref``.

    basis: (M, T, 128); w: (T, 128); mask: (M,) 0/1.  Returns (w_new,
    dots).  Loops vector by vector, as the reference's oracle does."""
    dots = reorth_dots_ref(basis, w, mask)
    return reorth_axpy_ref(w, basis, dots), dots


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        attn_softcap: float = 0.0, scale=None):
    """Same contract as ``kernels.flash_attention.flash_attention_fwd``.

    q: (B, H, Sq, hd); k, v: (B, KV, Sk, hd) -> (B, H, Sq, hd) in q's
    dtype.  Dense (unblocked) softmax attention in float32 — scores times
    ``hd**-0.5``, then the softcap, then the causal (``qpos >= kpos``) and
    window (``qpos - kpos < window``) masks with positions contiguous from
    0, filled with ``NEG_INF`` (not ``-inf``: a row masked entirely comes
    out as the uniform average of V) — the chain of
    ``repro.kernels.ref.flash_attention_ref``.  ``scale`` replaces
    ``hd**-0.5`` (the kernel wrapper's head-dim padding keeps the true
    hd's).  Differentiable: the flash dispatcher's backward recomputes
    through it."""
    B, H, Sq, hd = q.shape
    _, KV, Sk, _ = k.shape
    G = H // KV
    qf = q.float().reshape(B, KV, G, Sq, hd)
    scale = hd ** -0.5 if scale is None else scale
    s = torch.einsum("bkgqd,bksd->bkgqs", qf, k.float()) * scale
    if attn_softcap:
        s = attn_softcap * torch.tanh(s / attn_softcap)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= qpos - kpos < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return o.reshape(B, H, Sq, hd).to(q.dtype)
