"""The current mesh and conditional sharding hints — the port of
``repro/models/shard_hints.py``.

Model code asks what mesh it runs under (``current_mesh``, ``has_axis``,
``axis_size``) and routes accordingly: the MoE layer takes the
expert-parallel all-to-all (``models/moe_shardmap.py``) when the mesh has
a model axis.  The mesh is thread-local, entered with ``use_mesh(mesh)``
(the reference enters ``with mesh:``); outside one there is no mesh and
the model runs as on one device.  The mesh is a ``DeviceMesh`` (its
model group carries the collectives) or a ``MeshShape``
(``launch/mesh.py``; shapes only).

``hint`` / ``residual_hint`` are identities: the reference's
``with_sharding_constraint`` steers XLA's partitioner, and eager torch
has no partitioner to steer — each rank computes on the tensors it holds,
and the launch step places them (``launch/shardstore.py``).  Likewise
``batch_axes`` / ``activation_batch_axes`` only name the axes that would
shard the activation batch dim: each rank here already holds its own
rows.  The port's model code calls none of these four (the reference
calls ``residual_hint`` in its transformer block and ``batch_axes`` in
its all-to-all MoE); they are the module's API, tested, for code ported
from the reference, and do nothing.
"""
from __future__ import annotations

import contextlib
import threading

__all__ = ["use_mesh", "current_mesh", "mesh_axes", "hint", "batch_axes",
           "activation_batch_axes", "residual_hint", "has_axis",
           "axis_size", "model_group", "DATA_AXES"]

DATA_AXES = ("pod", "data")

_CTX = threading.local()


@contextlib.contextmanager
def use_mesh(mesh):
    """Run the block under ``mesh`` (``None``: no mesh)."""
    prev = getattr(_CTX, "mesh", None)
    _CTX.mesh = mesh
    try:
        yield mesh
    finally:
        _CTX.mesh = prev


def current_mesh():
    """The mesh of the surrounding ``use_mesh`` block, or None."""
    return getattr(_CTX, "mesh", None)


def mesh_axes() -> tuple:
    from ..launch.mesh import mesh_shape
    m = current_mesh()
    return () if m is None else mesh_shape(m).axis_names


def hint(x, *spec):
    """The reference's sharding constraint: the identity here (there is
    no partitioner to constrain)."""
    return x


def batch_axes():
    """Mesh axes that shard the activation batch dim in the current
    context: ``("pod", "data")`` by default (serving), ``()`` inside a
    training step (``activation_batch_axes(())``)."""
    return getattr(_CTX, "batch_axes", DATA_AXES)


@contextlib.contextmanager
def activation_batch_axes(axes):
    prev = getattr(_CTX, "batch_axes", DATA_AXES)
    _CTX.batch_axes = tuple(axes)
    try:
        yield
    finally:
        _CTX.batch_axes = prev


def residual_hint(x):
    """The reference's constraint on a (B, S, d) residual activation: the
    identity here, as ``hint``."""
    return hint(x, batch_axes(), *([None] * (x.dim() - 1)))


def has_axis(name: str) -> bool:
    return name in mesh_axes()


def axis_size(name: str) -> int:
    """The current mesh's size along ``name`` (1 without a mesh or such
    an axis)."""
    from ..launch.mesh import mesh_shape
    m = current_mesh()
    if m is None:
        return 1
    return mesh_shape(m).shape.get(name, 1)


def model_group():
    """The current mesh's model process group (None without a
    ``DeviceMesh``)."""
    m = current_mesh()
    if m is None or not hasattr(m, "get_group"):
        return None
    return m.get_group("model")
