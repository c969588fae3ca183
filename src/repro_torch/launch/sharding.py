"""Sharding rules: tree path -> partition spec, the port of
``repro/launch/sharding.py``, rule for rule.

A spec (``PartitionSpec``) is a tuple with one entry per tensor dim:
``None`` (not sharded), a mesh axis name, or a tuple of axis names, as
JAX's ``PartitionSpec`` has.  The rules, as the reference's code gives
them (its docstring calls them Megatron pairs; they are not, see
ROADMAP's reference notes):

  * leaves of 1 dim or none (norms, biases, gates)  -> replicated
  * "expert" leaves: 3 dims with ``mlp`` or ``experts`` in the path
    (a period-stacked dense MLP weight (Np, d, ff) is read as one too)
        -> dim 0 over ``model`` when it divides, else the ff dim (2, or 1
           for a row leaf), else the largest divisible dim
  * everything else -> the largest dim ``model`` divides, ties to the
    first dim for a row leaf (``wo``, ``w2``, ``down``, ``out_proj`` in
    the path), to the last otherwise; a 4-D stacked expert tensor
    (Np, E, d, ff) lands here and shards d
  * training adds a leading learner dim over the learner axes.

Paths are the tuples ``tree.tree_flatten_with_path`` gives (dict keys,
sequence indices, field names), joined by "/" and lowered as the
reference's ``_path_str`` does.  ``placements`` maps a spec to
``torch.distributed.tensor`` ``Shard(d)`` / ``Replicate()`` on a mesh
(the twin of ``named_shardings``).

The port's launch step (``launch/train.py``) stores each rank's slice of
every leaf as ``leaf_spec`` cuts it (``launch/shardstore.py``) and splits
the compute over the model group by batch rows; its decode keeps each
rank's cache shard as ``cache_sharding`` places it.
"""
from __future__ import annotations

from ..tree import (tree_flatten, tree_flatten_with_path, tree_map,
                    tree_unflatten)
from .mesh import MODEL, learner_axes, mesh_shape

__all__ = ["PartitionSpec", "P", "ROW_TOKENS", "leaf_spec",
           "params_sharding", "batch_sharding", "cache_sharding",
           "spec_dim", "placements"]

ROW_TOKENS = ("wo", "w2", "down", "out_proj")


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None``, an axis name or a tuple of
    axis names.  A leaf of a tree (``tree.py``), as JAX's is."""

    _tree_leaf = True

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P" + super().__repr__()


P = PartitionSpec


def _path_str(path) -> str:
    return "/".join(str(p) for p in path).lower()


def _pick_dim(shape, model_size: int, prefer_first: bool):
    divisible = [i for i, s in enumerate(shape)
                 if s % model_size == 0 and s >= model_size]
    if not divisible:
        return None
    return max(divisible, key=lambda i: (shape[i], -i if prefer_first else i))


def leaf_spec(path, leaf, model_size: int, *, model_axis: str = MODEL,
              learner_axes=None) -> PartitionSpec:
    """The spec of one (possibly learner-stacked) parameter leaf;
    ``leaf`` is anything with ``.shape``."""
    name = _path_str(path)
    shape = tuple(leaf.shape)
    lead = ()
    if learner_axes:
        lead = (learner_axes,)
        shape = shape[1:]

    if len(shape) <= 1:
        return P(*lead, *([None] * len(shape)))

    is_expert = ("mlp" in name and len(shape) == 3) or \
                ("experts" in name and len(shape) == 3)
    row = any(t in name for t in ROW_TOKENS)

    if is_expert:
        E = shape[0]
        if E % model_size == 0:
            dim = 0
        else:
            # shard the ff dim: w1/w3 (E, d, ff) -> 2 ; w2 (E, ff, d) -> 1
            dim = 1 if row else 2
            if shape[dim] % model_size:
                dim = _pick_dim(shape, model_size, prefer_first=row)
    else:
        dim = _pick_dim(shape, model_size, prefer_first=row)

    spec = [None] * len(shape)
    if dim is not None:
        spec[dim] = model_axis
    return P(*lead, *spec)


def params_sharding(params_shapes, mesh, *, stacked: bool):
    """A tree of specs matching a parameter tree (of tensors or anything
    with ``.shape``)."""
    size = mesh_shape(mesh).shape[MODEL]
    l_axes = learner_axes(mesh) if stacked else None
    _, treedef = tree_flatten(params_shapes)
    return tree_unflatten(treedef, [
        leaf_spec(path, leaf, size, learner_axes=l_axes)
        for path, leaf in tree_flatten_with_path(params_shapes)])


def _n_learners(mesh) -> int:
    sizes, n = mesh_shape(mesh).shape, 1
    for a in learner_axes(mesh):
        n *= sizes[a]
    return n


def batch_sharding(batch_shapes, mesh, *, stacked: bool):
    """Batch leaves, (L, B_local, ...) or (GB, ...): dim 0 over the
    learner axes when they divide it, everything else replicated.
    (``stacked`` is the reference's argument; its rule is the same
    either way.)"""
    l_axes, n_l = learner_axes(mesh), _n_learners(mesh)

    def one(leaf):
        nd = len(leaf.shape)
        if nd == 0:
            return P()
        if leaf.shape[0] % n_l == 0 and leaf.shape[0] >= n_l:
            return P(l_axes, *([None] * (nd - 1)))
        return P(*([None] * nd))

    return tree_map(one, batch_shapes)


def cache_sharding(cache_shapes, mesh):
    """Decode caches, leaves period-stacked (Np, B, ...): the batch dim
    (1) over the learner axes; an attention K/V cache (Np, B, W, KV, hd)
    shards its time dim W over ``model`` (the sequence-sharded KV cache);
    SSM, conv and mLSTM states shard their largest divisible trailing dim
    (of the last two); ``slot_pos`` bookkeeping is replicated.  The
    port's sequence-sharded decode (``train.make_decode_step(api, mesh)``)
    builds each rank's cache shard by this table and requires its
    attention buffers cut on W (a buffer the model size does not divide
    raises there): only the softmax's float32 partials cross ranks, and a
    recurrent layer gathers its state's slices for the update."""
    size = mesh_shape(mesh).shape[MODEL]
    l_axes, n_l = learner_axes(mesh), _n_learners(mesh)

    def one(path, leaf):
        name = _path_str(path)
        shape = tuple(leaf.shape)
        nd = len(shape)
        spec = [None] * nd
        if "slot_pos" in name:
            return P(*spec)
        if nd >= 2 and shape[1] % n_l == 0 and shape[1] >= n_l:
            spec[1] = l_axes              # batch dim (after the period dim)
        is_attn_kv = nd == 5 or ("xk" in name or "xv" in name)
        if is_attn_kv:
            w_dim = nd - 3                # (..., W, KV, hd)
            if shape[w_dim] % size == 0 and shape[w_dim] >= size:
                spec[w_dim] = MODEL
                return P(*spec)
        for d in (nd - 2, nd - 1):
            if d < 2:
                continue
            if spec[d] is None and shape[d] % size == 0 \
                    and shape[d] >= size:
                spec[d] = MODEL
                break
        return P(*spec)

    _, treedef = tree_flatten(cache_shapes)
    return tree_unflatten(treedef, [
        one(p, leaf) for p, leaf in tree_flatten_with_path(cache_shapes)])


def spec_dim(spec, axis: str = MODEL):
    """The tensor dim ``spec`` shards over ``axis``, or None."""
    for d, entry in enumerate(spec):
        if entry == axis or (isinstance(entry, tuple) and axis in entry):
            return d
    return None


def placements(spec, mesh) -> tuple:
    """``spec`` as ``torch.distributed.tensor`` placements, one per mesh
    dim: ``Shard(d)`` where a tensor dim d is sharded over that axis,
    ``Replicate()`` elsewhere (``named_shardings``' twin; DTensor takes
    them with the mesh)."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for axis in mesh_shape(mesh).axis_names:
        d = spec_dim(spec, axis)
        out.append(Replicate() if d is None else Shard(d))
    return tuple(out)
