"""Trees of tensors: nested dicts, lists and tuples with tensors (or other
objects) at the leaves — what the port needs in place of
``jax.tree_util``.

Dicts are walked in sorted key order at every level, which is the order
``jax.tree_util.tree_flatten`` uses, so a flattened tree here lines up leaf
for leaf with the reference's.  ``None`` is an empty subtree, as in JAX.
A NamedTuple is walked field by field and rebuilt as itself; a tuple
type with ``_tree_leaf = True`` (a partition spec) is a leaf.
``tree_flatten_with_path`` names each leaf by the path JAX gives it (dict
key, sequence index or field name), so ``"/".join`` of a path is the key
the reference's checkpoints store.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

__all__ = ["tree_flatten", "tree_unflatten", "tree_leaves", "tree_map",
           "tree_flatten_with_path"]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def _is_leaf_tuple(x) -> bool:
    """A tuple type that marks itself a leaf (``_tree_leaf``), as a
    partition spec does."""
    return getattr(type(x), "_tree_leaf", False)


def tree_flatten(tree) -> Tuple[List[Any], Any]:
    """-> (leaves, treedef).  ``None`` is an empty subtree, as in JAX."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        leaves, defs = [], []
        for k in keys:
            sub, d = tree_flatten(tree[k])
            leaves += sub
            defs.append(d)
        return leaves, ("dict", tuple(keys), tuple(defs))
    if isinstance(tree, (list, tuple)) and not _is_leaf_tuple(tree):
        leaves, defs = [], []
        for x in tree:
            sub, d = tree_flatten(x)
            leaves += sub
            defs.append(d)
        if _is_namedtuple(tree):
            return leaves, ("namedtuple", type(tree), tuple(defs))
        return leaves, (type(tree).__name__, None, tuple(defs))
    if tree is None:
        return [], ("none", None, ())
    return [tree], ("leaf", None, ())


def _count(treedef) -> int:
    kind, _, defs = treedef
    if kind == "leaf":
        return 1
    return sum(_count(d) for d in defs)


def tree_unflatten(treedef, leaves):
    leaves = list(leaves)
    kind, keys, defs = treedef
    if kind == "leaf":
        return leaves[0]
    if kind == "none":
        return None
    out, pos = [], 0
    for d in defs:
        c = _count(d)
        out.append(tree_unflatten(d, leaves[pos:pos + c]))
        pos += c
    if kind == "dict":
        return dict(zip(keys, out))
    if kind == "namedtuple":
        return keys(*out)
    return tuple(out) if kind == "tuple" else out


def tree_leaves(tree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest):
    leaves, treedef = tree_flatten(tree)
    others = [tree_leaves(r) for r in rest]
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])


def tree_flatten_with_path(tree, prefix=()) -> List[Tuple[tuple, Any]]:
    """-> [(path, leaf)], in ``tree_flatten``'s leaf order; a path is the
    tuple of dict keys, sequence indices and NamedTuple field names down
    to the leaf, as ``jax.tree_util.tree_flatten_with_path`` gives them."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in tree_flatten_with_path(tree[k], prefix + (k,))]
    if _is_namedtuple(tree):
        return [x for f, v in zip(type(tree)._fields, tree)
                for x in tree_flatten_with_path(v, prefix + (f,))]
    if isinstance(tree, (list, tuple)) and not _is_leaf_tuple(tree):
        return [x for i, v in enumerate(tree)
                for x in tree_flatten_with_path(v, prefix + (i,))]
    if tree is None:
        return []
    return [(prefix, tree)]
