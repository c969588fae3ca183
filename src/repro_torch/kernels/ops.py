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

from .. import obs
from ..core.flatstate import flatten_for_kernel
from . import ref
from .decode_attention import paged_decode_attention_fwd
from .flash_attention import (backward_kernel_takes, flash_attention_bwd,
                              flash_attention_fwd)
from .gossip_mix import (check_outputs, gossip_mix_update,
                         gossip_mix_update_flat)
from .reorth import reorth_axpy, reorth_dots

BACKENDS = ("auto", "cuda", "ref")


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths, *,
                           window: int = 0, attn_softcap: float = 0.0,
                           backend: str = "auto"):
    """Paged serving decode attention (DESIGN §14).

    q: (S, H, hd) — one query token per serve slot; k_pages, v_pages:
    (P, page, KV, hd) shared pools; page_table: (S, max_pages) int32
    physical page ids in logical order; lengths: (S,) int32 valid tokens
    per slot (current token included).  Inference only.  A CPU tensor, or
    ``backend="ref"``, takes the plain version; a CUDA tensor the kernel.
    """
    if _use_plain(q, backend):
        return ref.paged_decode_attention_ref(
            q, k_pages, v_pages, page_table, lengths, window=window,
            attn_softcap=attn_softcap)
    with obs.span("kernel.paged_decode"):
        return paged_decode_attention_fwd(
            q, k_pages, v_pages, page_table, lengths, window=window,
            attn_softcap=attn_softcap)


def _use_plain(t: torch.Tensor, backend: str) -> bool:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    return backend == "ref" or (backend == "auto" and t.device.type == "cpu")


def _flash_ref_bsh(q, k, v, causal, window, attn_softcap):
    """The plain version in the model layout (B, S, H, hd)."""
    o = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=causal,
                                window=window, attn_softcap=attn_softcap)
    return o.transpose(1, 2)


class FlashAttention(torch.autograd.Function):
    """The kernel forward and the backward kernel (``flash_attention_bwd``,
    ``csrc/flash_bwd.cu``): the forward saves q, k, v, its output and each
    row's log-sum-exp, from which the backward rebuilds P tile by tile.
    The TPU kernel has no backward kernel (the reference differentiates
    its oracle, ``repro/kernels/ops.py::_flash_bwd``); the tests hold this
    one to that gradient.  At a padded head dim of 256 no backward
    instance holds dK and dV in registers (``backward_kernel_takes``), so
    there, statically by shape, the gradient is the plain version's,
    recomputed from the saved q, k, v.

    Once differentiable: a backward that builds a graph (``create_graph``,
    as the landscape probe's HVP does) raises instead of differentiating
    the oracle behind the kernel's back; the reference cannot take that
    path either (JAX refuses forward-mode AD through its custom VJP).
    ``torch.autograd.function.once_differentiable`` is not enough here: its
    error node has no edge to the inputs, so ``torch.autograd.grad`` prunes
    it and silently drops the attention's second-order term."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, attn_softcap):
        ctx.mask = (causal, window, attn_softcap)
        with obs.span("kernel.flash_fwd"):
            o, lse = flash_attention_fwd(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                causal=causal, window=window, attn_softcap=attn_softcap,
                return_lse=True)
        o = o.transpose(1, 2)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, g):
        if torch.is_grad_enabled():
            raise RuntimeError(
                "FlashAttention is once differentiable: its backward runs "
                "a kernel (or the plain version's recompute), and a double "
                "backward (create_graph=True) through the kernel is not "
                "supported; run the model with use_pallas=False for "
                "second-order derivatives")
        q, k, v, o, lse = ctx.saved_tensors
        causal, window, attn_softcap = ctx.mask
        if not backward_kernel_takes(q.shape[-1]):
            with torch.enable_grad():
                qkv = [t.detach().requires_grad_() for t in (q, k, v)]
                o = _flash_ref_bsh(*qkv, *ctx.mask)
                dq, dk, dv = torch.autograd.grad(o, qkv, g)
            return dq, dk, dv, None, None, None
        with obs.span("kernel.flash_bwd"):
            qt, kt, vt, ot, gt = (t.transpose(1, 2) for t in (q, k, v, o, g))
            dq, dk, dv = flash_attention_bwd(
                qt, kt, vt, ot, lse, gt, causal=causal, window=window,
                attn_softcap=attn_softcap)
        return (dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2),
                None, None, None)


def flash_attention(q, k, v, *, q_positions=None, k_positions=None,
                    causal: bool = True, window: int = 0,
                    attn_softcap: float = 0.0, backend: str = "auto"):
    """Model-layout flash attention (training / prefill).  q: (B, Sq, H,
    hd); k, v: (B, Sk, KV, hd) -> (B, Sq, H, hd).

    Positions are contiguous from 0; ``q_positions`` / ``k_positions`` are
    accepted for the signature of ``chunked_attention`` and not read (as
    in the reference), so the call makes no host sync.  A CUDA tensor goes
    through ``FlashAttention`` (the kernel forward and backward) where a
    gradient is wanted, else straight to the kernel forward, which then
    stores no row statistic; a CPU tensor, or ``backend="ref"``, through
    the plain version with its own autograd.
    """
    if _use_plain(q, backend):
        return _flash_ref_bsh(q, k, v, causal, window, attn_softcap)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, window, attn_softcap)
    with obs.span("kernel.flash_fwd"):
        o = flash_attention_fwd(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=causal,
                                window=window, attn_softcap=attn_softcap)
    return o.transpose(1, 2)


def flat_gossip_update(w, remote, grads, momentum, partners, coefs, *,
                       lr: float, beta: float = 0.0, weight_decay: float = 0.0,
                       buffer=None, out=None, buffer_out=None,
                       backend: str = "auto"):
    """Batched fused gossip + SGD update on the persistent (n, T, 128) store
    (DESIGN §11): one pass of ``kernels/gossip_mix.py`` over every learner.
    ``remote`` is the (R, T, 128) stack the partner ids ``(K, n)`` index:
    ``w`` itself (R = n) for a fleet on one device, or one rank's K
    received neighbour rows (R = K, n = 1) on the launch path
    (``launch/train.py``).

    ``momentum=None`` selects the momentum-free update; otherwise the
    momentum is updated IN PLACE.  ``buffer`` (AD-PSGD) switches on publish
    mode.  The new weights go to ``out`` and the new published buffer to
    ``buffer_out`` (fresh tensors when None); neither may overlap an input.
    Returns (w_new, momentum[, buffer_new]), ``momentum`` None when absent.
    """
    has_momentum = momentum is not None
    mu = momentum if has_momentum else w      # not read without momentum
    if not _use_plain(w, backend):
        with obs.span("kernel.gossip_update"):
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
                    remote=None, backend: str = "auto"):
    """One mixing-only gossip round on the flat (n, T, 128) store.

    ``partners``: (K, n) int32 ids into ``remote`` (default ``w``; on the
    launch path a rank's (K, T, 128) received rows); ``coefs``: (n, K + 1)
    float32 ``[self, neighbours...]`` — one row of a compiled
    GossipSchedule.  Multi-round schedules run their leading rounds
    through this and fuse the optimizer update into the last round only.
    The same kernel with lr = 0 and ``w`` as the (unused) gradient
    operand.  ``active`` ((n,) bool): inactive rows are copied unchanged.
    """
    n = w.shape[0]
    ones = torch.ones((n, 1), dtype=torch.float32, device=w.device)
    act = ones if active is None else active.to(torch.float32)[:, None]
    full = torch.cat([coefs.to(torch.float32), ones, act], dim=1)
    return flat_gossip_update(w, w if remote is None else remote, w, None,
                              partners, full, lr=0.0, out=out,
                              backend=backend)[0]


def reorthogonalize(basis, w, mask, *, backend: str = "auto",
                    reduce_dots=None):
    """Fully reorthogonalize ``w`` against the masked basis prefix
    (DESIGN §10): two classical Gram-Schmidt sweeps (CGS2, "twice is
    enough").

    basis: (M, T, 128) stacked flat Lanczos vectors; w: (T, 128)
    candidate; mask: (M,) 0/1 float32 marking the live prefix.  A CUDA
    tensor goes through the dots and axpy kernels of
    ``kernels/reorth.py`` (the first sweep writes a fresh tensor, the
    second writes into it in place; ``w`` is not touched); a CPU tensor, or
    ``backend="ref"``, through their plain versions
    (``ref.reorth_dots_ref`` then ``ref.reorth_axpy_ref``: one sweep of
    ``ref.reorth_ref``).  Returns the new w.

    ``reduce_dots`` (a function of the (M,) dots) runs between each
    sweep's dots and its axpy: a basis sharded over ranks passes the sum
    over its shards (``all_reduce``), so each rank's axpy subtracts the
    full projections from its shard.
    """
    red = reduce_dots or (lambda d: d)
    plain = _use_plain(w, backend)
    for sweep in range(2):
        if plain:
            w = ref.reorth_axpy_ref(w, basis,
                                    red(ref.reorth_dots_ref(basis, w, mask)))
        else:
            w = reorth_axpy(w, basis, red(reorth_dots(basis, w, mask)),
                            out=w if sweep else None)
    return w


def dpsgd_fused_update(params_tree, neighbor_trees, grads_tree,
                       momentum_tree, coefs, *, lr: float, beta: float = 0.9,
                       backend: str = "auto"):
    """Tree-level fused gossip + momentum update of one learner: each tree
    flattened to the (T, 128) float32 layout (``flatten_for_kernel``), the
    neighbour trees stacked to (K, T, 128), one pass of
    ``gossip_mix_update`` (``coefs``: ``[self, nbr...]``, a list or a
    tensor), then unflattened.  Returns (new_params_tree,
    new_momentum_tree).  A CPU tensor, or ``backend="ref"``, takes the
    plain version."""
    w, unflatten_w = flatten_for_kernel(params_tree)
    mu, unflatten_mu = flatten_for_kernel(momentum_tree)
    g, _ = flatten_for_kernel(grads_tree)
    nbrs = torch.stack([flatten_for_kernel(t)[0] for t in neighbor_trees])
    c = torch.as_tensor(coefs, dtype=torch.float32, device=w.device)
    if _use_plain(w, backend):
        w_new, mu_new = ref.gossip_mix_update_ref(w, nbrs, g, mu, c, lr=lr,
                                                  beta=beta)
    else:
        w_new, mu_new = gossip_mix_update(w, nbrs, g, mu, c, lr=lr,
                                          beta=beta)
    return unflatten_w(w_new), unflatten_mu(mu_new)
