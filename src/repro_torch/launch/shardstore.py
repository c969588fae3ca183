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

The per-period layout (a transformer's tree: leaves under ``periods``
stacked (Np, ...) over its Np periods, the rest -- embedding, final norm,
head -- apart).  A *section* is period p's leaves at index p (each leaf
without its period dim, ``period_meta``) or the non-period leaves
(``rest_meta``); ``LearnerGather`` gathers one section at a time and
reduces its gradient back into the shard.  A leaf of a section is one of
three kinds, by the dim ``leaf_spec`` cuts:

  * ``ag``: cut on a dim other than the period dim (every non-period leaf
    that is cut): rank j holds slice j of the section's leaf, so the
    section's full leaf is one ``all_gather`` of the M slices; its
    gradient one ``reduce_scatter`` (SUM).  A rank sends its slice and
    receives M - 1 slices.
  * ``own``: a period leaf cut on the period dim (``P('model', ...)``,
    e.g. transformer-100m's ``periods/l0/mlp/w1`` at M = 2): rank j holds
    periods [j Np/M, (j+1) Np/M) whole, so period p lives on one rank,
    ``owner(p) = p // (Np / M)``.  Its gather is a ``broadcast`` from the
    owner (the owner sends the leaf's [p], each other rank receives it);
    its gradient a ``reduce`` (SUM) to the owner (each other rank sends
    it, the owner receives M - 1).
  * ``rep``: replicated: every rank holds it whole; no collective (its
    gradient joins the replicated tail's one ``all_reduce``).

A section's ``ag`` leaves go in one collective and its ``own`` leaves in
another, so gathering period p takes an ``all_gather`` and, where the
period has ``own`` leaves, a ``broadcast``; its gradient a
``reduce_scatter`` and a ``reduce``.  Over two model ranks every sum
is one addition, so a period-by-period gradient is bitwise the whole
store's; over more, a collective of another size may order a sum
otherwise (gloo: jamba's smoke config on (1, 4), 2.3e-13 on one rank's
shard after two SSGD steps), rounding-level.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch

from ..core.dpsgd import HostStaging
from ..core.flatstate import LANE, ROW_ALIGN, FlatMeta, flat_meta
from ..tree import tree_flatten, tree_flatten_with_path, tree_unflatten
from .sharding import leaf_spec, spec_dim

__all__ = ["ShardLayout", "GroupComm", "LearnerGather"]


class _Section(NamedTuple):
    """One section of a learner's leaves (period p's, or the non-period
    ones): its full layout, and per section leaf its full leaf index, kind
    (``ag`` / ``own`` / ``rep``) and the section leaf's dim cut over the
    model group (``ag`` only); ``ag`` / ``own`` are the elements of a
    rank's all_gather piece and of the owner's broadcast."""
    meta: FlatMeta
    leaves: tuple
    kinds: tuple
    split: tuple
    ag: int
    own: int


def _numel(shape) -> int:
    n = 1
    for x in shape:
        n *= int(x)
    return n


def _meta_tree(tree, drop_lead: bool):
    """``tree``'s leaves as meta tensors (the leading dim dropped)."""
    from ..tree import tree_map
    return tree_map(lambda x: torch.empty(
        tuple(x.shape[1:] if drop_lead else x.shape), dtype=x.dtype,
        device="meta"), tree)


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
        self._sections(tree)
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

    # -- the per-period layout ---------------------------------------------
    def _sections(self, tree) -> None:
        """The period and non-period sections (module docstring)."""
        self.paths = [p for p, _ in tree_flatten_with_path(tree)]
        per = [bool(p) and p[0] == "periods" for p in self.paths]
        self.n_periods = (self.full.shapes[per.index(True)][0]
                          if any(per) else 0)
        self.period = self.rest = None
        if self.n_periods:
            self.period = self._section(
                _meta_tree(tree["periods"], True),
                [i for i, x in enumerate(per) if x], True)
        rest = ({k: v for k, v in tree.items() if k != "periods"}
                if isinstance(tree, dict) else tree)
        self.rest = self._section(_meta_tree(rest, False),
                                  [i for i, x in enumerate(per) if not x],
                                  False)

    def _section(self, meta_tree, leaves, period: bool) -> _Section:
        meta = flat_meta(meta_tree)
        kinds, split, ag, own = [], [], 0, 0
        for i, shape in zip(leaves, meta.shapes):
            d = self.dims[i]
            if d is None:
                kinds.append("rep")
                split.append(None)
            elif period and d == 0:
                kinds.append("own")
                split.append(None)
                own += _numel(shape)
            else:
                kinds.append("ag")
                split.append(d - 1 if period else d)
                ag += _numel(shape) // self.M
        return _Section(meta, tuple(leaves), tuple(kinds), tuple(split),
                        ag, own)

    def section(self, p: Optional[int]) -> _Section:
        """Period p's section, or the non-period leaves' (``p`` None)."""
        if p is None:
            return self.rest
        if not 0 <= p < self.n_periods:
            raise ValueError(f"period {p} of {self.n_periods}")
        return self.period

    def owner(self, p: int) -> int:
        """The model rank that holds period p of the leaves cut on the
        period dim."""
        return p // (self.n_periods // self.M)

    def _piece(self, views, i: int, p: Optional[int], kind: str):
        """Leaf i's local slice for section p: its [p] (or the owner's
        [p mod Np/M]) of a period leaf, the whole local leaf else."""
        x = views[i]
        if p is None:
            return x
        return x[p % (self.n_periods // self.M)] if kind == "own" else x[p]

    def send_section(self, store, p, ag_out, own_out) -> None:
        """This rank's pieces of section p from its (T_local, 128) store:
        its slices of the ``ag`` leaves into ``ag_out`` (``ag`` elements);
        the ``own`` leaves' [p] into ``own_out`` on the owner."""
        sec, lv = self.section(p), self.local.views(store)
        a = b = 0
        with torch.no_grad():
            for i, kind, shape in zip(sec.leaves, sec.kinds,
                                      sec.meta.shapes):
                if kind == "ag":
                    x = self._piece(lv, i, p, kind)
                    ag_out[a:a + x.numel()].copy_(x.reshape(-1))
                    a += x.numel()
                elif kind == "own":
                    n = _numel(shape)
                    if self.owner(p) == self.j:
                        own_out[b:b + n].copy_(
                            self._piece(lv, i, p, kind).reshape(-1))
                    b += n

    def assemble_section(self, store, p, ag_stack, own_buf, out) -> None:
        """Section p's full leaves into ``out`` (one tensor per section
        leaf, any dtype: ``copy_`` casts) from the (M, ag) gathered stack,
        the owner's broadcast and this rank's store (``rep`` leaves)."""
        sec, lv = self.section(p), self.local.views(store)
        a = b = 0
        with torch.no_grad():
            for k, (i, kind, d) in enumerate(zip(sec.leaves, sec.kinds,
                                                 sec.split)):
                f = out[k]
                if kind == "ag":
                    n = f.numel() // self.M
                    piece = self._split(f, d)
                    piece.copy_(ag_stack[:, a:a + n].view(piece.shape))
                    a += n
                elif kind == "own":
                    f.copy_(own_buf[b:b + f.numel()].view(f.shape))
                    b += f.numel()
                else:
                    f.copy_(self._piece(lv, i, p, kind))

    def pack_section_grad(self, p, grads, ag_stack, own_buf) -> None:
        """Section p's full gradient (one tensor per section leaf) into
        the (M, ag) stack (slice m of each ``ag`` leaf into slot m) and the
        ``own`` buffer."""
        sec = self.section(p)
        a = b = 0
        with torch.no_grad():
            for g, kind, d in zip(grads, sec.kinds, sec.split):
                if kind == "ag":
                    n = g.numel() // self.M
                    piece = self._split(g, d)
                    ag_stack[:, a:a + n].view(piece.shape).copy_(piece)
                    a += n
                elif kind == "own":
                    own_buf[b:b + g.numel()].copy_(g.reshape(-1))
                    b += g.numel()

    def scatter_section_grad(self, p, ag_piece, own_buf, grads, grad_store,
                             rep) -> None:
        """The model group's summed ``ag`` slices (``ag_piece``) and, on
        the owner, ``own`` leaves into this rank's (T_local, 128)
        ``grad_store``; the ``rep`` leaves of ``grads`` (this rank's full
        section gradient) into ``rep``, the replicated tail's order."""
        sec, lv = self.section(p), self.local.views(grad_store)
        a = b = 0
        with torch.no_grad():
            for i, kind, g in zip(sec.leaves, sec.kinds, grads):
                if kind == "ag":
                    x = self._piece(lv, i, p, kind)
                    x.copy_(ag_piece[a:a + x.numel()].view(x.shape))
                    a += x.numel()
                elif kind == "own":
                    if self.owner(p) == self.j:
                        x = self._piece(lv, i, p, kind)
                        x.copy_(own_buf[b:b + g.numel()].view(x.shape))
                    b += g.numel()
                else:
                    off = self.local.offsets[i] - self.rep_start + (
                        0 if p is None else p * g.numel())
                    rep[off:off + g.numel()].copy_(g.reshape(-1))

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


# the most stack a staged all_gather puts through pinned host memory at once
STAGE_BYTES = 1 << 30


class GroupComm:
    """A process group's collectives on float32 tensors: ``all_gather``
    into a stack, ``reduce_scatter`` (SUM) of a stack, ``all_reduce``
    (SUM) of a buffer, ``broadcast`` from a rank and ``reduce`` (SUM) to a
    rank.  On a ``gloo`` group CUDA tensors are staged through
    ``core/dpsgd.HostStaging``'s pinned buffers.  A group of one rank
    copies and posts nothing.  Counts its calls (by kind) and the bytes
    each brings into the rank."""

    def __init__(self, group, device):
        import torch.distributed as dist
        self.group, self.device = group, device
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
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
        """``stack`` (size, *local.shape) <- every rank's ``local``.  A
        staged gather whose stack passes ``STAGE_BYTES`` goes through the
        host in element ranges of at most that much stack (one call in the
        counts): the pinned buffers stay bounded, not the size of a
        learner's largest section (gemma2-27b's embedding: 4.7 GB)."""
        import torch.distributed as dist
        if self.size == 1:
            return stack[0].copy_(local)[None]

        def op(o, i):
            dist.all_gather_into_tensor(o, i, group=self.group)
        moved = (self.size - 1) * local.numel() * local.element_size()
        n = local.numel()
        step = max(STAGE_BYTES // (self.size * local.element_size()), 1)
        if self._staging is None or n <= step:
            # the collective takes the stack as one (size * rows, ...)
            self._run(op, "ag", stack.view((-1,) + tuple(local.shape[1:])),
                      local.contiguous(), moved, "all_gather")
            return stack
        flat, cols = local.reshape(-1), stack.view(self.size, -1)
        for c0 in range(0, n, step):
            c1 = min(n, c0 + step)
            part = torch.empty((self.size, c1 - c0), dtype=local.dtype,
                               device=local.device)
            self._staging.run(op, "agc", part.view(-1),
                              flat[c0:c1].contiguous())
            cols[:, c0:c1].copy_(part)
        self.calls += 1
        self.bytes += moved
        self.kinds["all_gather"] = self.kinds.get("all_gather", 0) + 1
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

    def broadcast(self, buf: torch.Tensor, src: int):
        """``buf`` <- group rank ``src``'s ``buf``, in place."""
        import torch.distributed as dist
        if self.size == 1:
            return buf
        peer = dist.get_global_rank(self.group, src)
        self._run(lambda o, i: dist.broadcast(o, peer, group=self.group),
                  f"bc{tuple(buf.shape)}", buf, buf,
                  0 if self.rank == src else buf.numel()
                  * buf.element_size(), "broadcast")
        return buf

    def reduce(self, buf: torch.Tensor, dst: int):
        """Group rank ``dst``'s ``buf`` <- the sum over ranks, in place
        (the others' ``buf`` is left undefined)."""
        import torch.distributed as dist
        if self.size == 1:
            return buf
        peer = dist.get_global_rank(self.group, dst)
        self._run(lambda o, i: dist.reduce(o, peer, group=self.group),
                  f"rd{tuple(buf.shape)}", buf, buf,
                  (self.size - 1) * buf.numel() * buf.element_size()
                  if self.rank == dst else 0, "reduce")
        return buf

    def release(self) -> None:
        """Drop the pinned staging buffers (after a one-off gather)."""
        if self._staging is not None:
            self._staging = type(self._staging)()


class LearnerGather:
    """A learner's weights over its model group one section at a time
    (``ShardLayout``'s per-period layout): ``gather(store, p)`` gives
    section p's full leaves (p None: the non-period leaves) from this
    rank's (T_local, 128) ``store``, one ``all_gather`` (and, for a period
    with leaves cut on the period dim, one ``broadcast``) on ``comm``;
    ``reduce(p, grads, grad_store, rep)`` returns a section's full
    gradient to the rank's shard, one ``reduce_scatter`` (and one
    ``reduce``).  Staging buffers are kept between sections; what a
    gather returns is fresh.  ``max_full_bytes`` is the largest full
    section it has made (the step's largest full buffer)."""

    def __init__(self, layout: ShardLayout, comm: "GroupComm", device):
        self.lay, self.comm, self.device = layout, comm, device
        self._bufs = {}
        self.max_full_bytes = 0

    def release(self) -> None:
        """Drop the kept staging buffers (after a one-off gather)."""
        self._bufs = {}
        self.comm.release()

    def _buf(self, key: str, shape) -> torch.Tensor:
        buf = self._bufs.get(key)
        if buf is None or buf.numel() < _numel(shape):
            buf = self._bufs[key] = torch.empty((_numel(shape),),
                                                device=self.device)
        return buf[:_numel(shape)].view(shape)

    def gather(self, store: torch.Tensor, p: Optional[int], out=None,
               dtypes: bool = False) -> List[torch.Tensor]:
        """Section p's full leaves: views of a fresh float32 (T_s, 128)
        buffer, or with ``dtypes`` fresh tensors in each leaf's own dtype;
        ``out`` (one tensor per section leaf) is written instead."""
        lay, M = self.lay, self.lay.M
        sec = lay.section(p)
        if out is None:
            if dtypes:
                out = [torch.empty(s, dtype=dt, device=self.device)
                       for s, dt in zip(sec.meta.shapes, sec.meta.dtypes)]
            else:
                out = sec.meta.views(torch.zeros(
                    (sec.meta.rows, LANE), device=self.device))
        self.max_full_bytes = max(self.max_full_bytes, sum(
            x.numel() * x.element_size() for x in out))
        send = self._buf("send", (sec.ag,))
        stack = self._buf("stack", (M, sec.ag))
        own = self._buf("own", (sec.own,))
        lay.send_section(store, p, send, own)
        if sec.ag:
            self.comm.all_gather(send, stack)
        if sec.own:
            self.comm.broadcast(own, lay.owner(p))
        lay.assemble_section(store, p, stack, own, out)
        return out

    def reduce(self, p: Optional[int], grads, grad_store: torch.Tensor,
               rep: torch.Tensor) -> None:
        """Section p's full gradient ``grads`` (one tensor per section
        leaf, this rank's rows) summed over the model group into this
        rank's (T_local, 128) ``grad_store``; its replicated leaves into
        ``rep`` (summed later with the rest of the replicated tail)."""
        lay, M = self.lay, self.lay.M
        sec = lay.section(p)
        stack = self._buf("stack", (M, sec.ag))
        piece = self._buf("piece", (sec.ag,))
        own = self._buf("own", (sec.own,))
        lay.pack_section_grad(p, grads, stack, own)
        if sec.ag:
            self.comm.reduce_scatter(stack, piece)
        if sec.own:
            self.comm.reduce(own, lay.owner(p))
        lay.scatter_section_grad(p, piece, own, grads, grad_store, rep)
