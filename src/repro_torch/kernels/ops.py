"""Public dispatchers over the port's kernels.

The rule (as in ``repro.kernels.ops``, with the device taking the place of
the JAX backend): a CPU tensor goes to the plain version in ``ref``; a
CUDA tensor goes to the hand-written kernel, which launches or raises.
Nothing falls back from a failed build or launch.  Where a dispatcher takes
``backend``, ``"ref"`` is the one explicit way to run the plain version on
the card (the reference's ``kernel_backend="ref"``); ``"cuda"`` insists on
the kernel.
"""
from __future__ import annotations

import torch

from . import ref
from .decode_attention import paged_decode_attention_fwd
from .gossip_mix import check_outputs, gossip_mix_update_flat

BACKENDS = ("auto", "cuda", "ref")


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths, *,
                           window: int = 0, attn_softcap: float = 0.0):
    """Paged serving decode attention (DESIGN §14).

    q: (S, H, hd) — one query token per serve slot; k_pages, v_pages:
    (P, page, KV, hd) shared pools; page_table: (S, max_pages) int32
    physical page ids in logical order; lengths: (S,) int32 valid tokens
    per slot (current token included).  Inference only.
    """
    if q.device.type == "cpu":
        return ref.paged_decode_attention_ref(
            q, k_pages, v_pages, page_table, lengths, window=window,
            attn_softcap=attn_softcap)
    return paged_decode_attention_fwd(
        q, k_pages, v_pages, page_table, lengths, window=window,
        attn_softcap=attn_softcap)


def _use_plain(t: torch.Tensor, backend: str) -> bool:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    return backend == "ref" or (backend == "auto" and t.device.type == "cpu")


def flat_gossip_update(w, remote, grads, momentum, partners, coefs, *,
                       lr: float, beta: float = 0.0, weight_decay: float = 0.0,
                       buffer=None, out=None, buffer_out=None,
                       backend: str = "auto"):
    """Batched fused gossip + SGD update on the persistent (n, T, 128) store
    (DESIGN §11): one pass of ``kernels/gossip_mix.py`` over every learner.

    ``momentum=None`` selects the momentum-free update; otherwise the
    momentum is updated IN PLACE.  ``buffer`` (AD-PSGD) switches on publish
    mode.  The new weights go to ``out`` and the new published buffer to
    ``buffer_out`` (fresh tensors when None); neither may overlap an input.
    Returns (w_new, momentum[, buffer_new]), ``momentum`` None when absent.
    """
    has_momentum = momentum is not None
    mu = momentum if has_momentum else w      # not read without momentum
    if not _use_plain(w, backend):
        res = gossip_mix_update_flat(
            w, remote, grads, mu, partners, coefs, lr=lr, beta=beta,
            weight_decay=weight_decay, has_momentum=has_momentum,
            buffer=buffer, out=out, buffer_out=buffer_out)
        return (res[0], momentum) + tuple(res[2:])
    check_outputs({"w": w, "remote": remote, "grads": grads,
                   "momentum": momentum, "buffer": buffer},
                  {"out": out, "buffer_out": buffer_out})
    res = ref.gossip_mix_update_flat_ref(
        w, remote, grads, mu, partners, coefs, lr=lr, beta=beta,
        weight_decay=weight_decay, has_momentum=has_momentum, buffer=buffer)
    w_new = res[0] if out is None else out.copy_(res[0])
    if has_momentum:
        momentum.copy_(res[1])
    if buffer is None:
        return w_new, momentum
    buf_new = res[2] if buffer_out is None else buffer_out.copy_(res[2])
    return w_new, momentum, buf_new


def flat_gossip_mix(w, partners, coefs, *, active=None, out=None,
                    backend: str = "auto"):
    """One mixing-only gossip round on the flat (n, T, 128) store.

    ``partners``: (K, n) int32; ``coefs``: (n, K + 1) float32 ``[self,
    neighbours...]`` — one row of a compiled GossipSchedule.  Multi-round
    schedules run their leading rounds through this and fuse the optimizer
    update into the last round only.  The same kernel with lr = 0 and ``w``
    as the (unused) gradient operand.  ``active`` ((n,) bool): inactive
    rows are copied unchanged.
    """
    n = w.shape[0]
    ones = torch.ones((n, 1), dtype=torch.float32, device=w.device)
    act = ones if active is None else active.to(torch.float32)[:, None]
    full = torch.cat([coefs.to(torch.float32), ones, act], dim=1)
    return flat_gossip_update(w, w, w, None, partners, full, lr=0.0,
                              out=out, backend=backend)[0]
