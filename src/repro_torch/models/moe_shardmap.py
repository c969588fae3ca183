"""Expert-parallel MoE with an explicit all-to-all over the model group —
the port of ``repro/models/moe_shardmap.py``.

Each model rank holds E / M experts (its slice of the expert dim) and
routes its own tokens; the communication is stated, as GShard / Switch /
MaxText run it:

  per rank (one model coordinate of the current mesh):
    1. route the local tokens (x is this rank's (B, S, d) slice)
    2. pack them into per-destination-rank buffers (M, cap_send, d)
    3. ``all_to_all`` over the model group: each rank receives the tokens
       routed to its experts
    4. the capacity-bucketed FFN of its E / M experts, (E/M, cap_expert, d)
    5. the reverse ``all_to_all``, then the gate-weighted combine

Capacities are the reference's: cap_send = ceil(cf · k · T_loc / M),
cap_expert = ceil(2 · M · cap_send / (E / M)), at least 1 each; an
assignment past either lands in a trash column and contributes 0.

Gradients flow through ``AllToAll``, an autograd function whose backward
is the same all-to-all (its own transpose for equal splits) and is itself
differentiable, so the probe's double backward runs through it.  On a
``gloo`` group CUDA tensors are staged through ``core/dpsgd.HostStaging``'s
pinned host buffers (gloo reads host memory); they move as raw bytes,
whatever their dtype.

Applies when the current mesh has a model axis M > 1 with E % M == 0 and
S % M == 0 (``shardmap_applicable``); the transformer's ``_mlp`` routes
``moe_backend="shard_map"`` here then, and to ``moe.moe_forward``
otherwise, as the reference does.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core.dpsgd import HostStaging
from .moe import route
from .shard_hints import axis_size, has_axis, model_group

__all__ = ["moe_forward_shardmap", "shardmap_applicable", "capacities",
           "AllToAll", "all_to_all"]


def shardmap_applicable(n_experts: int, seq: int) -> bool:
    if not has_axis("model"):
        return False
    m = axis_size("model")
    return n_experts % m == 0 and seq % m == 0 and m > 1


def _a2a_raw(x: torch.Tensor, group) -> torch.Tensor:
    """Equal-split all-to-all along dim 0 of a contiguous tensor, moved as
    raw bytes."""
    import torch.distributed as dist
    x = x.contiguous()
    raw = x.view(torch.uint8) if x.dtype != torch.uint8 else x
    raw = raw.reshape(x.shape[0], -1)
    out = torch.empty_like(raw)

    def op(o, i):
        dist.all_to_all_single(o, i, group=group)
    if HostStaging.needed(group, x.device):
        _STAGING.run(op, f"a2a{tuple(raw.shape)}", out, raw)
    else:
        op(out, raw)
    all_to_all.calls += 1
    return out.view(x.dtype).reshape(x.shape)


_STAGING = HostStaging()


class AllToAll(torch.autograd.Function):
    """y[r] = x_r'[me] over the group: the all-to-all of dim 0; its
    backward is the same all-to-all of the cotangent."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _a2a_raw(x, group)

    @staticmethod
    def backward(ctx, g):
        return AllToAll.apply(g, ctx.group), None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable equal-split all-to-all of ``x`` along dim 0 (one
    block of dim 0 per rank of ``group``)."""
    if x.requires_grad:
        return AllToAll.apply(x, group)
    return _a2a_raw(x, group)


all_to_all.calls = 0


def _local_moe(xt, router, w1, w3, w2, *, n_experts_local: int, top_k: int,
               n_ranks: int, cap_send: int, cap_expert: int, group,
               stats=None):
    """One rank's dispatch / FFN / combine.  xt: (T_loc, d) local tokens;
    w1, w3, w2: this rank's E/M experts."""
    T, d = xt.shape
    dev = xt.device

    _, gates, eids = route(xt.float() @ router, top_k)          # (T, k)

    # ---- pack per destination rank --------------------------------------
    tgt = torch.div(eids, n_experts_local,
                    rounding_mode="floor").reshape(-1)           # (T*k,)
    loc_e = torch.remainder(eids, n_experts_local).reshape(-1)
    pos = torch.cumsum(F.one_hot(tgt, n_ranks), dim=0) - 1
    pos = pos.gather(1, tgt[:, None])[:, 0]
    keep = pos < cap_send
    se = torch.where(keep, tgt, 0)
    sc = torch.where(keep, pos, cap_send)                        # trash col
    src = torch.repeat_interleave(xt, top_k, dim=0)
    send_x = torch.zeros((n_ranks, cap_send + 1, d), dtype=xt.dtype,
                         device=dev).index_put((se, sc), src)[:, :cap_send]
    send_e = torch.full((n_ranks, cap_send + 1), -1, dtype=torch.int64,
                        device=dev).index_put(
        (se, sc), torch.where(keep, loc_e, -1))[:, :cap_send]

    # ---- exchange ---------------------------------------------------------
    recv_x = all_to_all(send_x, group)
    recv_e = all_to_all(send_e, group)

    # ---- local expert buckets -------------------------------------------
    fe = recv_e.reshape(-1)                                      # (M*C_r,)
    fx = recv_x.reshape(-1, d)
    valid = fe >= 0
    fe_safe = torch.where(valid, fe, 0)
    oh2 = F.one_hot(fe_safe, n_experts_local) * valid[:, None]
    pos2 = torch.cumsum(oh2, dim=0) - 1
    pos2 = pos2.gather(1, fe_safe[:, None])[:, 0]
    keep2 = valid & (pos2 < cap_expert)
    be = torch.where(keep2, fe_safe, 0)
    bc = torch.where(keep2, pos2, cap_expert)
    buf = torch.zeros((n_experts_local, cap_expert + 1, d), dtype=xt.dtype,
                      device=dev).index_put((be, bc), fx)[:, :cap_expert]
    if stats is not None:
        stats.update(
            cap_send=cap_send, cap_expert=cap_expert,
            sent=torch.bincount(se[keep], minlength=n_ranks),
            dropped_send=torch.sum(~keep),
            kept_expert=torch.bincount(be[keep2],
                                       minlength=n_experts_local),
            dropped_expert=torch.sum(valid & ~keep2))

    h = F.silu(torch.bmm(buf, w1)) * torch.bmm(buf, w3)
    out = torch.bmm(h, w2)                                       # (E_l, C_e, d)

    # ---- return to senders ----------------------------------------------
    ret = out[be, torch.clamp(bc, max=cap_expert - 1)]
    ret = torch.where(keep2[:, None], ret, 0.0).reshape(n_ranks, cap_send, d)
    back = all_to_all(ret, group)

    # ---- combine ----------------------------------------------------------
    gathered = back[se, torch.clamp(sc, max=cap_send - 1)]
    gathered = torch.where(keep[:, None], gathered, 0.0)
    w = (gates.reshape(-1) * keep.to(gates.dtype))[:, None]
    y = torch.sum((gathered * w.to(gathered.dtype)).reshape(T, top_k, d),
                  dim=1)
    return y.to(xt.dtype)


def capacities(n_experts: int, top_k: int, t_loc: int, m: int,
               capacity_factor: float):
    """(cap_send, cap_expert) of the reference's formulas."""
    cap_send = max(1, math.ceil(capacity_factor * top_k * t_loc / m))
    cap_expert = max(1, math.ceil(2.0 * m * cap_send / (n_experts // m)))
    return cap_send, cap_expert


def moe_forward_shardmap(params, x, *, n_experts: int, top_k: int,
                         capacity_factor: float = 1.25, group=None,
                         stats=None):
    """x: (B, S, d), this rank's tokens, under a mesh with a model axis
    (or with ``group``, the model process group, given).  ``params``: the
    MoE's (``MoEParams`` or a dict) with w1, w3, w2 holding either all E
    experts (this rank takes its E / M) or this rank's E / M.  Returns
    (B, S, d).  ``stats`` (a dict) receives the capacities, the
    assignments this rank sent to each rank, those it dropped at
    ``cap_send``, the tokens each local expert kept and those it dropped
    at ``cap_expert`` (device tensors)."""
    import torch.distributed as dist

    group = model_group() if group is None else group
    if group is None:
        raise ValueError("the expert-parallel MoE runs under a DeviceMesh "
                         "with a model axis (use_mesh) or a given group")
    m = dist.get_world_size(group)
    j = dist.get_rank(group)
    get = (params.get if isinstance(params, dict)
           else lambda k: getattr(params, k))
    e_loc = n_experts // m
    w1, w3, w2 = get("w1"), get("w3"), get("w2")
    if w1.shape[0] == n_experts:
        w1, w3, w2 = (w.narrow(0, j * e_loc, e_loc) for w in (w1, w3, w2))
    B, S, d = x.shape
    cap_send, cap_expert = capacities(n_experts, top_k, B * S, m,
                                      capacity_factor)
    y = _local_moe(x.reshape(B * S, d), get("router"), w1, w3, w2,
                   n_experts_local=e_loc, top_k=top_k, n_ranks=m,
                   cap_send=cap_send, cap_expert=cap_expert, group=group,
                   stats=stats)
    return y.reshape(B, S, d)
