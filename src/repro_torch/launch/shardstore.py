"""A learner's parameters over its model group: each rank's shard store.

``ShardLayout`` cuts a parameter tree as the reference's sharding rules
place it (``launch/sharding.py::leaf_spec``): model rank j of M keeps
slice j of every leaf along the leaf's ``model`` dim, and the whole of a
replicated leaf.  The slices are one flat (T_local, 128) float32 store
(``FlatMeta``, the layout of ``core/flatstate.py`` over the local
shapes), so the launch step's momentum, published buffer and receive
stack keep the one-buffer layout of slice 7a over the shard: the
reference's ``gossip_fuse="flat"`` buffer of the local shard.  The
sharded leaves come first in tree order and the replicated ones after
them, so the replicated elements are one contiguous tail
(``rep_start``, ``rep_end``) that a collective can take whole.

Every rank of the model group has the same local layout (the rules cut
every model dim evenly), so an ``all_gather`` of the M local stores is an
(M, T_local, 128) stack, and:

  * ``assemble(stack, full)`` writes the learner's full store (the
    ``FlatMeta`` of the whole tree) from the stack: a sharded leaf is the
    concatenation of its M slices along its model dim, a replicated leaf
    is slot 0's copy;
  * ``pack(full, stack)`` is its transpose for gradients: slice m of
    every sharded leaf into slot m, so a ``reduce_scatter`` (SUM) of the
    stack gives rank j the model group's summed gradient of its shard.
    Replicated leaves are not packed (the launch step sums their
    gradient with an ``all_reduce``, so every rank gets the same bits;
    the sharded probe packs them into slot 0, ``pack(rep_slot=0)``).

``GroupComm`` runs a group's collectives (the model group's gather,
reduce-scatter and all-reduce; the sharded probe's over the learner
group too, and SSGD's gradient over the learners); on a ``gloo`` group
CUDA tensors are staged through ``core/dpsgd.HostStaging``'s pinned host
buffers (gloo reads host memory), as the gossip exchange is.

With M = 1 the layout is the full tree's ``FlatMeta`` itself.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from ..core.dpsgd import HostStaging
from ..core.flatstate import LANE, ROW_ALIGN, FlatMeta, flat_meta
from ..tree import tree_flatten, tree_flatten_with_path, tree_unflatten
from .sharding import leaf_spec, spec_dim

__all__ = ["ShardLayout", "GroupComm"]


class ShardLayout:
    """Model rank ``model_rank`` of ``model_size``'s slice of ``tree`` (a
    learner's parameter tree in the reference's layout; leaves may be on
    the meta device: only shapes and dtypes are read)."""

    def __init__(self, tree, model_size: int, model_rank: int):
        if not 0 <= model_rank < model_size:
            raise ValueError(f"model rank {model_rank} of {model_size}")
        self.M, self.j = int(model_size), int(model_rank)
        self.full: FlatMeta = flat_meta(tree)
        dims, shapes = [], []
        for (path, leaf), shape in zip(tree_flatten_with_path(tree),
                                       self.full.shapes):
            d = (None if self.M == 1 else
                 spec_dim(leaf_spec(path, leaf, self.M)))
            dims.append(d)
            local = list(shape)
            if d is not None:
                local[d] //= self.M
            shapes.append(tuple(local))
        self.dims = tuple(dims)
        if self.M == 1:
            self.local, self.rep_start, self.rep_end = self.full, 0, 0
            return
        sizes = []
        for s in shapes:
            n = 1
            for x in s:
                n *= x
            sizes.append(n)
        order = ([i for i, d in enumerate(dims) if d is not None]
                 + [i for i, d in enumerate(dims) if d is None])
        offsets, off = [0] * len(sizes), 0
        for i in order:
            offsets[i] = off
            off += sizes[i]
        n_shard = sum(sizes[i] for i in order if dims[i] is not None)
        rows = -(-off // LANE)
        rows += (-rows) % ROW_ALIGN
        self.local = FlatMeta(self.full.treedef, tuple(shapes),
                              self.full.dtypes, tuple(sizes),
                              tuple(offsets), off, rows)
        self.rep_start, self.rep_end = n_shard, off

    @property
    def n_rep(self) -> int:
        """Elements of the replicated tail."""
        return self.rep_end - self.rep_start

    def local_tree(self, tree):
        """This rank's slice of a full tree (views of its leaves)."""
        leaves, treedef = tree_flatten(tree)
        out = []
        for x, d, s in zip(leaves, self.dims, self.local.shapes):
            out.append(x if d is None else x.narrow(d, self.j * s[d], s[d]))
        return tree_unflatten(treedef, out)

    def flatten_local(self, tree, *, device=None) -> torch.Tensor:
        """A full tree -> this rank's (T_local, 128) float32 store."""
        return self.local.flatten(self.local_tree(tree), device=device)

    def _stack_views(self, stack: torch.Tensor) -> List[torch.Tensor]:
        """Each leaf's (M, *local shape) view across the stack's slots."""
        flat = stack.reshape(stack.shape[0], -1)
        return [flat[:, off:off + sz].view((stack.shape[0],) + shape)
                for off, sz, shape in zip(self.local.offsets,
                                          self.local.sizes,
                                          self.local.shapes)]

    def _split(self, full_leaf: torch.Tensor, d: int) -> torch.Tensor:
        """A full leaf as an (M, *local shape) view: slice m along d."""
        return full_leaf.unflatten(d, (self.M, -1)).movedim(d, 0)

    def assemble(self, stack: torch.Tensor, full: torch.Tensor) -> None:
        """(M, T_local, 128) stack -> the full (T, 128) store ``full``."""
        with torch.no_grad():
            for x, v, d in zip(self.full.views(full),
                               self._stack_views(stack), self.dims):
                if d is None:
                    x.copy_(v[0])
                else:
                    self._split(x, d).copy_(v)

    def pack(self, full: torch.Tensor, stack: torch.Tensor,
             rep_slot: Optional[int] = None) -> None:
        """The full (T, 128) gradient ``full`` -> the (M, T_local, 128)
        ``stack``: slice m of each sharded leaf into slot m.  Replicated
        leaves go whole into slot ``rep_slot`` (zeros in the others), or
        are left as they are when ``rep_slot`` is None."""
        with torch.no_grad():
            for x, v, d in zip(self.full.views(full),
                               self._stack_views(stack), self.dims):
                if d is not None:
                    v.copy_(self._split(x, d))
                elif rep_slot is not None:
                    v.zero_()
                    v[rep_slot].copy_(x)

    def pack_rep(self, full: torch.Tensor, out: torch.Tensor) -> None:
        """The replicated leaves of the full (T, 128) store ``full`` into
        ``out`` (at least ``n_rep`` elements), in the local tail's order."""
        flat = out.reshape(-1)
        with torch.no_grad():
            for x, off, sz, d in zip(self.full.views(full),
                                     self.local.offsets, self.local.sizes,
                                     self.dims):
                if d is None:
                    flat[off - self.rep_start:off - self.rep_start + sz] \
                        .copy_(x.reshape(-1))

    def rep_tail(self, store: torch.Tensor) -> torch.Tensor:
        """The replicated tail of a local store (a flat view)."""
        return store.reshape(-1)[self.rep_start:self.rep_end]


class GroupComm:
    """A process group's collectives on float32 tensors: ``all_gather``
    into a stack, ``reduce_scatter`` (SUM) of a stack, ``all_reduce``
    (SUM) of a buffer.  On a ``gloo`` group CUDA tensors are staged
    through ``core/dpsgd.HostStaging``'s pinned buffers.  A group of one
    rank copies and posts nothing.  Counts its calls and the bytes each
    brings into the rank."""

    def __init__(self, group, device):
        import torch.distributed as dist
        self.group, self.device = group, device
        self.size = dist.get_world_size(group)
        self._staging = (HostStaging() if HostStaging.needed(group, device)
                         else None)
        self.calls = 0
        self.bytes = 0
        self.kinds = {}         # calls by collective

    def _run(self, op, key, out: torch.Tensor, inp: torch.Tensor,
             moved: int, kind: str):
        """``op(out, inp)`` on the group, staged through host buffers
        ``key`` when the group is gloo and the tensors on a card."""
        if self._staging is not None:
            self._staging.run(op, key, out, inp)
        else:
            op(out, inp)
        self.calls += 1
        self.bytes += moved
        self.kinds[kind] = self.kinds.get(kind, 0) + 1

    def all_gather(self, local: torch.Tensor, stack: torch.Tensor):
        """``stack`` (size, *local.shape) <- every rank's ``local``."""
        import torch.distributed as dist
        if self.size == 1:
            return stack[0].copy_(local)[None]
        # the collective takes the stack as one (size * rows, ...) tensor
        self._run(lambda o, i: dist.all_gather_into_tensor(
            o, i, group=self.group), "ag", stack.view((-1,) + tuple(
                local.shape[1:])), local.contiguous(),
            (self.size - 1) * local.numel() * local.element_size(),
            "all_gather")
        return stack

    def reduce_scatter(self, stack: torch.Tensor, out: torch.Tensor):
        """``out`` <- the sum over ranks of their ``stack[rank]``."""
        import torch.distributed as dist
        if self.size == 1:
            return out.copy_(stack[0])
        self._run(lambda o, i: dist.reduce_scatter_tensor(
            o, i, group=self.group), "rs", out,
            stack.view((-1,) + tuple(out.shape[1:])),
            (self.size - 1) * out.numel() * out.element_size(),
            "reduce_scatter")
        return out

    def all_reduce(self, buf: torch.Tensor):
        """``buf`` <- the sum over ranks, in place."""
        import torch.distributed as dist
        if self.size == 1:
            return buf
        self._run(lambda o, i: dist.all_reduce(o, group=self.group),
                  f"ar{tuple(buf.shape)}", buf, buf,
                  buf.numel() * buf.element_size(), "all_reduce")
        return buf
