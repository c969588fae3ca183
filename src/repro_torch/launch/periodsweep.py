"""The landscape probe's gradient and Hessian-vector product on the
per-period gather: a learner over its model group, one section of its
weights full at a time.

``PeriodSweep(api, layout, comm, device)(w, batch, scale, v=None)`` is,
on model rank j, this rank's rows' gradient of ``scale * loss_fn`` at the
learner's weights ``w`` (``v`` None) or its Hessian-vector product H v,
summed over the model group and returned as the rank's (T_local, 128)
shard, the replicated tail on model rank 0 (zeros on the others) as the
sharded probe keeps its vectors.  ``w`` is the rank's float32 store (its
replicated tail whole, as a training step's is); ``v`` a vector in the
probe's convention (its replicated tail on model rank 0).

The HVP is forward over reverse, the reference's order (``jax.jvp`` of
``jax.grad``), a period at a time through ``models.model.period_loss``:

  * forward: the non-period leaves of w and v gathered once
    (``LearnerGather``); (x_0, x'_0) = jvp(pre); for each period p, (w_p,
    v_p) gathered and (x_p+1, x'_p+1) = jvp(body, (w_p, x_p), (v_p,
    x'_p)), keeping only the boundary activations and their tangents;
  * the head: jvp of post's vjp at (rest, x_Np) gives the rest's gradient
    and its tangent, the cotangent xb_Np and its tangent;
  * backward: for each period from the last, (w_p, v_p) gathered again
    and jvp of body's vjp at (w_p, x_p, xb_p+1) in the direction (v_p,
    x'_p, xb'_p+1): its tangent outputs are (H v)_p and xb'_p, which the
    rank's section reduce (``LearnerGather.reduce``: a reduce_scatter
    and, for leaves cut on the period dim, a reduce) returns to its
    shard at once;
  * the embedding: jvp of pre's vjp; the rest's (H v) reduced; one
    ``all_reduce`` sums the replicated leaves' part over the model group.

Every collective runs outside the ``torch.func`` transforms, and the full
weights a rank holds are the non-period leaves and one period
(``max_full_bytes``); v, H v and the gradient are held full over the same
sections at the same time.  The non-period leaves of w stay gathered
from one sweep to the next while w is the same tensor (a probe's sweeps all
run at w_a; ``release`` drops them), and the last period's (w, v) stay
from the forward into the backward, which starts with it: each sweep
gathers the other periods twice.  Reverse over reverse
(``landscape/hvp.py``, the whole probe's) would keep every period's
recomputed graph, and its gathered weights, alive until the second
backward.

Refused (``ValueError``, at construction): a model with no stacked
periods (the encoder-decoder), ``use_pallas`` (the flash kernel's
``autograd.Function`` has no forward-mode formula) and
``moe_backend="shard_map"`` (neither has the all-to-all's).  The mamba
scan, the xLSTM cells, the einsum MoE and M-RoPE run forward-mode.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.flatstate import LANE
from ..models.model import ModelAPI, period_loss
from ..tree import tree_leaves, tree_unflatten
from .shardstore import GroupComm, LearnerGather, ShardLayout

__all__ = ["PeriodSweep"]


def _refusal(api: ModelAPI, layout: ShardLayout) -> Optional[str]:
    cfg = api.cfg
    if not layout.n_periods:
        return "its tree has no stacked periods"
    if cfg.use_pallas:
        return ("use_pallas: the flash kernel's autograd.Function has no "
                "forward-mode formula")
    if cfg.n_experts and cfg.moe_backend == "shard_map":
        return ("moe_backend='shard_map': the all-to-all's autograd."
                "Function has no forward-mode formula")
    return None


class PeriodSweep:
    """One rank's gradient or H v over the learner's sections (module
    docstring).  ``max_full_bytes``: the most full weight bytes held at
    once (the non-period leaves' buffer and one period's)."""

    def __init__(self, api: ModelAPI, layout: ShardLayout, comm: GroupComm,
                 device):
        why = _refusal(api, layout)
        if why is not None:
            raise ValueError(f"gather='period' does not probe "
                             f"{api.cfg.name}: {why}")
        self.api, self.layout, self.comm = api, layout, comm
        self.device = device
        self.parts = period_loss(api.cfg)
        self._gat = LearnerGather(layout, comm, device)
        self.max_full_bytes = 0
        self._w = self._w_rest = None

    def release(self) -> None:
        """Drop the kept non-period leaves of w (at the end of a probe)."""
        self._w = self._w_rest = None

    def _section(self, store, p):
        """Section p's full leaves of ``store`` as its tree, and the bytes
        of the fresh buffer they view."""
        lay = self.layout
        sec = lay.section(p)
        leaves = self._gat.gather(store, p)
        return (tree_unflatten(sec.meta.treedef, leaves),
                leaves[0].untyped_storage().nbytes())

    def _reduce(self, p, tree, out, rep) -> None:
        self._gat.reduce(p, [x.float() for x in tree_leaves(tree)], out, rep)

    def __call__(self, w: torch.Tensor, batch, scale,
                 v: Optional[torch.Tensor] = None) -> torch.Tensor:
        from torch.func import jvp, vjp

        lay, parts, comm = self.layout, self.parts, self.comm
        tangent = v is not None
        if tangent:
            # every rank's copy of v's replicated leaves (model rank 0's)
            v = v.clone()
            if lay.n_rep:
                comm.all_reduce(lay.rep_tail(v))
        pos = parts.positions(batch)

        def pre(r):
            return parts.pre(r, batch)

        def body(wp, x):
            return parts.body(wp, x, pos)

        def head(r, x):
            loss, back = vjp(lambda r_, x_: parts.post(r_, x_, batch)
                             * scale, r, x)
            return back(torch.ones_like(loss))

        def embed_back(r, xb):
            return vjp(pre, r)[1](xb)[0]

        def body_back(wp, x, xb):
            return vjp(body, wp, x)[1](xb)

        if self._w is not w:
            self._w, self._w_rest = w, self._section(w, None)
        w_rest, rest_bytes = self._w_rest
        v_rest = self._section(v, None)[0] if tangent else None
        xs, dxs = [], []
        if tangent:
            x, dx = jvp(pre, (w_rest,), (v_rest,))
        else:
            x, dx = pre(w_rest), None
        for p in range(lay.n_periods):
            xs.append(x)
            dxs.append(dx)
            wp, nbytes = self._section(w, p)
            vp = self._section(v, p)[0] if tangent else None
            self.max_full_bytes = max(self.max_full_bytes,
                                      rest_bytes + nbytes)
            if tangent:
                x, dx = jvp(body, (wp, x), (vp, dx))
            else:
                x = body(wp, x)
        last = (wp, vp)         # the backward starts with the last period
        del wp, vp
        if tangent:
            (g_rest, xb), (h_rest, dxb) = jvp(head, (w_rest, x),
                                              (v_rest, dx))
        else:
            g_rest, xb = head(w_rest, x)
        del x, dx
        out = torch.zeros((lay.local.rows, LANE), device=self.device)
        rep = torch.zeros((max(lay.n_rep, 1),), device=self.device)
        for p in reversed(range(lay.n_periods)):
            if last is not None:
                (wp, vp), last = last, None
            else:
                wp = self._section(w, p)[0]
                vp = self._section(v, p)[0] if tangent else None
            if tangent:
                (_, xb), (hw, dxb) = jvp(body_back, (wp, xs[p], xb),
                                         (vp, dxs[p], dxb))
            else:
                hw, xb = body_back(wp, xs[p], xb)     # the gradient
            xs[p] = dxs[p] = wp = vp = None
            self._reduce(p, hw, out, rep)
            del hw
        if tangent:
            _, h_embed = jvp(embed_back, (w_rest, xb), (v_rest, dxb))
            rest = {k: h_rest[k] + h_embed[k] for k in h_rest}
        else:
            g_embed = embed_back(w_rest, xb)
            rest = {k: g_rest[k] + g_embed[k] for k in g_rest}
        self._reduce(None, rest, out, rep)
        comm.all_reduce(rep)
        tail = lay.rep_tail(out)
        if lay.j == 0:
            tail.copy_(rep[:lay.n_rep])
        else:
            tail.zero_()
        return out
