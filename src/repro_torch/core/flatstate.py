"""Flat-state parameter store: the (T, 128) float32 layout as a persistent
buffer — the port of ``repro/core/flatstate.py``.

``FlatMeta`` records a parameter tree's structure once: the leaves in the
reference's order (``jax.tree_util.tree_flatten`` order, dict keys sorted
at every level), their shapes, dtypes, sizes and offsets, and the padded
row count T (rounded up to ``ROW_ALIGN``).  So the port's ``(n, T, 128)``
store equals the reference's element for element.

  * ``flatten`` builds the buffer; the trainer calls it once, at init.
    The buffer is float32 whatever the leaves' dtypes, as the reference's
    ``flatten(dtype=float32)``.
  * ``unflatten`` returns per-leaf VIEWS into a buffer (no copy) for
    float32 leaves; a leaf of another dtype comes back as a cast copy, as
    the reference's ``astype`` does.
  * ``views`` returns every leaf as a float32 view of the buffer, whatever
    its recorded dtype: what the trainer binds and casts from
    (``view_tree``: the same views as a tree).
  * ``scatter`` writes a tree of per-leaf values (a gradient tree, say)
    into a zeroed float32 buffer slot by slot — the transpose of
    ``unflatten`` — skipping ``None`` leaves and leaving their slots and
    the pad region zero.

Gradients reach one flat grad buffer without a parameter-sized ``cat``
through the trainer's binding (``core/trainer.py``): every float32 leaf
view is made its own autograd leaf and its ``.grad`` is preset to the
matching view of the grad buffer, so autograd's accumulation adds into
that buffer in place.  A leaf of another dtype (bf16) cannot be a view of
the float32 store: the trainer casts it into a persistent leaf of its own
dtype before each forward and writes its gradient back into the float32
grad buffer after the backward, as the reference's custom VJP scatters
``ct.astype(float32)``.  (Differentiating through slices of one big leaf instead would make
PyTorch's slice backward allocate a buffer-sized zero tensor per leaf — the
torch form of the pad-and-add transpose the reference's custom VJP avoids.)

The pad region is written as zeros by ``flatten`` and never escapes:
``unflatten`` drops it, and no gradient lands there.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Any, List, Tuple

import numpy as np
import torch

from ..tree import tree_flatten, tree_unflatten

__all__ = ["LANE", "ROW_ALIGN", "FlatMeta", "flat_meta",
           "flatten_for_kernel"]

LANE = 128
ROW_ALIGN = 8           # row count a multiple of 8, as the reference's


@dataclasses.dataclass(frozen=True)
class FlatMeta:
    """Static description of a tree's flat (T, 128) layout."""
    treedef: Any
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]    # per-leaf dtypes, restored on unflatten
    sizes: Tuple[int, ...]
    offsets: Tuple[int, ...]
    n_elem: int                        # real (unpadded) element count
    rows: int                          # T: padded row count, multiple of 8

    @classmethod
    def for_tree(cls, tree) -> "FlatMeta":
        """Metadata of ``tree``'s structure: the same cached instance as
        ``flat_meta``."""
        return flat_meta(tree)

    @property
    def padded(self) -> int:
        return self.rows * LANE

    def leading(self, tree) -> Tuple[int, ...]:
        """Leading axes (e.g. the learner axis) a tree carries over the
        recorded leaf shapes."""
        for leaf, shape in zip(tree_flatten(tree)[0], self.shapes):
            return tuple(leaf.shape[:leaf.dim() - len(shape)])
        return ()

    def wire_dtype(self) -> torch.dtype:
        """The single dtype all leaves share, or float32 for a mixed tree:
        what the flat gossip exchange puts on the wire (a uniformly bf16
        model moves 2 bytes an element; the mixing runs in float32)."""
        return self.dtypes[0] if len(set(self.dtypes)) == 1 \
            else torch.float32

    def flatten(self, tree, *, device=None) -> torch.Tensor:
        """Tree (leaves ``lead + shape``) -> ``lead + (T, 128)`` float32
        buffer on ``device`` (default: the leaves' device).  Writes each
        leaf into its slot of one zeroed buffer — no concatenate."""
        leaves = tree_flatten(tree)[0]
        lead = self.leading(tree)
        dev = leaves[0].device if device is None else device
        out = torch.zeros(lead + (self.padded,), dtype=torch.float32,
                          device=dev)
        for leaf, off, sz in zip(leaves, self.offsets, self.sizes):
            out[..., off:off + sz] = leaf.reshape(lead + (sz,))
        return out.view(lead + (self.rows, LANE))

    def scatter(self, tree) -> torch.Tensor:
        """Tree (leaves ``lead + shape``) -> ``lead + (T, 128)`` float32
        buffer on the leaves' device, each leaf written in place into its
        slot of one zeroed buffer (no concatenate).  ``None`` leaves (a
        gradient that does not exist) are skipped, their slots left zero,
        and the leaves after them keep their offsets; the pad region stays
        zero."""
        leaves = _leaves_up_to(self.treedef, tree)
        present = [(x, s) for x, s in zip(leaves, self.shapes)
                   if x is not None]
        if not present:
            raise ValueError("scatter needs at least one leaf that is not "
                             "None")
        x0, s0 = present[0]
        lead = tuple(x0.shape[:x0.dim() - len(s0)])
        out = torch.zeros(lead + (self.padded,), dtype=torch.float32,
                          device=x0.device)
        for leaf, off, sz in zip(leaves, self.offsets, self.sizes):
            if leaf is not None:
                out[..., off:off + sz] = leaf.reshape(lead + (sz,))
        return out.view(lead + (self.rows, LANE))

    def views(self, flat: torch.Tensor) -> List[torch.Tensor]:
        """``lead + (T, 128)`` buffer -> its leaves, in order, as views in
        the buffer's own dtype (no cast, no copy)."""
        lead = tuple(flat.shape[:-2])
        v = flat.reshape(lead + (self.padded,))
        return [v[..., off:off + sz].view(lead + shape)
                for off, sz, shape in zip(self.offsets, self.sizes,
                                          self.shapes)]

    def view_tree(self, flat: torch.Tensor):
        """``lead + (T, 128)`` buffer -> tree of its leaf views in the
        buffer's own dtype (``views`` as a tree)."""
        return tree_unflatten(self.treedef, self.views(flat))

    def unflatten(self, flat: torch.Tensor):
        """``lead + (T, 128)`` buffer -> tree of per-leaf views (float32
        leaves) or cast copies (other dtypes)."""
        leaves = [leaf if dt == flat.dtype else leaf.to(dt)
                  for leaf, dt in zip(self.views(flat), self.dtypes)]
        return tree_unflatten(self.treedef, leaves)


def _leaves_up_to(treedef, tree) -> List[Any]:
    """``tree``'s subtrees at ``treedef``'s leaf positions, in order: a
    ``None`` where the recorded tree has a leaf stays in the list, so the
    leaves after it keep their offsets."""
    kind, keys, defs = treedef
    if kind == "leaf":
        return [tree]
    if kind == "none":
        return []
    items = [tree[k] for k in keys] if kind == "dict" else list(tree)
    return [x for d, sub in zip(defs, items)
            for x in _leaves_up_to(d, sub)]


@lru_cache(maxsize=64)
def _meta_cached(treedef, shapes, dtypes) -> FlatMeta:
    sizes = tuple(int(np.prod(s, dtype=np.int64)) for s in shapes)
    offsets, off = [], 0
    for sz in sizes:
        offsets.append(off)
        off += sz
    rows = -(-off // LANE)
    rows += (-rows) % ROW_ALIGN
    return FlatMeta(treedef, shapes, dtypes, sizes, tuple(offsets), off,
                    rows)


def flat_meta(tree) -> FlatMeta:
    """FlatMeta for ``tree``'s structure (leaves as given: no learner
    axis), cached per (structure, shapes, dtypes)."""
    leaves, treedef = tree_flatten(tree)
    return _meta_cached(treedef, tuple(tuple(x.shape) for x in leaves),
                        tuple(x.dtype for x in leaves))


def flatten_for_kernel(tree):
    """Tree -> ((T, 128) float32 buffer, unflatten): the port's copy of
    ``repro/kernels/gossip_mix.py::flatten_for_kernel``, for the one-shot
    kernel wrappers (``ops.dpsgd_fused_update``).  ``unflatten`` restores
    each leaf's shape and dtype; float32 leaves come back as views."""
    meta = flat_meta(tree)
    return meta.flatten(tree), meta.unflatten
