"""Learner groups and device meshes: the port of ``repro/launch/mesh.py``.

The reference's learners are the non-``model`` axes of a device mesh
(``learner_axes``, ``n_learners``); each learner is one model-parallel
group of chips (the paper's App. F "super-learner"): a production mesh is
(data=16, model=16) on one pod, (pod=2, data=16, model=16) on two.

Here a mesh is a ``torch.distributed`` ``DeviceMesh`` with the same axis
names, one rank a device.  Rank (i, j) of a ``("data", "model")`` mesh
holds model shard j of learner i: its learner group (``learner_group``)
is the ranks of every learner at model coordinate j, over which it
gossips point to point, and its model group (``model_group``) the M ranks
of learner i, over which it gathers the weights and reduce-scatters the
gradient (``launch/shardstore.py``).  A mesh of model size 1 is exactly
slice 7a's learner group: one whole learner a rank.

``MeshShape`` is a mesh's axis names and sizes without devices or
process groups: what the sharding rules (``launch/sharding.py``) and the
spec builders read, so a production mesh's specs are built on a machine
with no such mesh.  Every helper here takes a ``DeviceMesh`` or a
``MeshShape``.

Nothing here reads a cluster from the environment: the caller gives the
group its address, size and rank (``init_learner_group``, ``init_mesh``),
as ``torch.distributed`` needs on a machine that tells a program nothing
of a cluster.
"""
from __future__ import annotations

import datetime
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ..device import resolve_device

__all__ = ["MeshShape", "mesh_shape", "init_learner_group", "init_mesh",
           "make_mesh", "make_production_mesh", "make_test_mesh",
           "production_mesh_shape", "learner_axes", "n_learners",
           "learner_rank", "model_size", "model_rank", "learner_group",
           "model_group"]

MODEL = "model"
_LEARNER_GROUPS = "_repro_learner_groups"


class MeshShape(NamedTuple):
    """A mesh's axis names and sizes, without devices."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))


def mesh_shape(mesh) -> MeshShape:
    """The ``MeshShape`` of a ``DeviceMesh`` (or a ``MeshShape`` as is)."""
    if isinstance(mesh, MeshShape):
        return mesh
    return MeshShape(tuple(mesh.mesh_dim_names), tuple(mesh.mesh.shape))


def _is_mesh(x) -> bool:
    return isinstance(x, MeshShape) or hasattr(x, "mesh_dim_names")


def init_learner_group(rank: int, world_size: int, init_method: str, *,
                       device=None, backend: Optional[str] = None,
                       timeout_s: float = 300.0) -> torch.device:
    """Join the default process group as learner ``rank`` of
    ``world_size`` and return this rank's device.

    ``backend`` is ``"nccl"`` unless the caller names ``"gloo"``; an
    ``nccl`` group on a CPU device raises ``ValueError``.  Nothing
    switches backend when the init fails: the error propagates.  With
    ``nccl`` the rank's device becomes its current CUDA device (one GPU a
    rank: pass ``device=f"cuda:{local_rank}"``; a bare ``"cuda"`` is the
    current device); ``gloo`` ranks may share one card, or run on the CPU
    with ``device="cpu"``."""
    import torch.distributed as dist

    dev = resolve_device(device)
    backend = "nccl" if backend is None else backend
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got "
                         f"{backend!r}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"an nccl group needs CUDA tensors, got device "
                         f"{dev}; name backend='gloo' for the CPU")
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def make_mesh(shape: Sequence[int], axes: Sequence[str]):
    """A ``DeviceMesh`` of ``shape`` over the initialized default group,
    axes named ``axes`` (the last is ``"model"``), ranks laid out row
    major.  Its device type is ``cuda`` on an ``nccl`` group and ``cpu``
    on a ``gloo`` one (gloo ranks may still hold CUDA tensors: the mesh
    only names the groups)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes) or not axes or axes[-1] != MODEL:
        raise ValueError(f"a mesh's axes end in 'model': got {axes} for "
                         f"shape {shape}")
    size = 1
    for s in shape:
        size *= s
    if size != dist.get_world_size():
        raise ValueError(f"mesh {shape} holds {size} ranks, the group "
                         f"{dist.get_world_size()}")
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mesh = init_device_mesh(kind, shape, mesh_dim_names=axes)
    learner_group(mesh)     # two learner axes: their groups, built once
    return mesh


def init_mesh(rank: int, shape: Sequence[int], init_method: str, *,
              axes: Sequence[str] = ("data", MODEL), device=None,
              backend: Optional[str] = None, timeout_s: float = 300.0):
    """``init_learner_group`` over every rank of ``shape``, then
    ``make_mesh``: returns (mesh, this rank's device)."""
    world = 1
    for s in shape:
        world *= int(s)
    dev = init_learner_group(rank, world, init_method, device=device,
                             backend=backend, timeout_s=timeout_s)
    return make_mesh(shape, axes), dev


def production_mesh_shape(*, multi_pod: bool = False) -> MeshShape:
    """The reference's production meshes: (data=16, model=16), or
    (pod=2, data=16, model=16) multi-pod."""
    if multi_pod:
        return MeshShape(("pod", "data", MODEL), (2, 16, 16))
    return MeshShape(("data", MODEL), (16, 16))


def make_production_mesh(*, multi_pod: bool = False):
    """``make_mesh`` at the production shape (256 or 512 ranks)."""
    s = production_mesh_shape(multi_pod=multi_pod)
    return make_mesh(s.sizes, s.axis_names)


def make_test_mesh(n_data: int = 4, n_model: int = 2):
    """A small (data, model) mesh over the initialized default group."""
    return make_mesh((n_data, n_model), ("data", MODEL))


def learner_axes(mesh) -> tuple:
    """Mesh axes that enumerate learners: every axis but ``model``."""
    return tuple(a for a in mesh_shape(mesh).axis_names if a != MODEL)


def model_size(mesh) -> int:
    """The model axis' size (1 when the mesh has none)."""
    return mesh_shape(mesh).shape.get(MODEL, 1)


def n_learners(group=None) -> int:
    """The learner count: the product of a mesh's learner axes, or a
    process group's size (one learner a rank)."""
    if _is_mesh(group):
        n, sizes = 1, mesh_shape(group).shape
        for a in learner_axes(group):
            n *= sizes[a]
        return n
    import torch.distributed as dist
    return dist.get_world_size(group)


def learner_rank(group=None) -> int:
    """This process's learner: its coordinate over a mesh's learner axes
    (row major), or its rank in a process group."""
    import torch.distributed as dist
    if not _is_mesh(group):
        return dist.get_rank(group)
    coord, names, sizes = (group.get_coordinate(), group.mesh_dim_names,
                           mesh_shape(group).shape)
    i = 0
    for a, c in zip(names, coord):
        if a != MODEL:
            i = i * sizes[a] + c
    return i


def model_rank(mesh) -> int:
    """This process's model coordinate (0 when the mesh has no model
    axis)."""
    if MODEL not in mesh.mesh_dim_names:
        return 0
    return mesh.get_local_rank(MODEL)


def model_group(mesh):
    """The process group of this rank's learner: the ranks of its model
    axis."""
    return mesh.get_group(MODEL)


def learner_group(mesh):
    """The process group of the ranks at this rank's model coordinate,
    one a learner, in learner order: what a learner gossips over.  With
    one learner axis it is that axis' group.  With several (``pod`` and
    ``data``) it is one of the mesh's groups a model coordinate, which
    ``make_mesh`` builds once, while every rank makes the mesh; a mesh
    made elsewhere builds them at its first call here (a collective
    call) and keeps them."""
    axes = learner_axes(mesh)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    groups = getattr(mesh, _LEARNER_GROUPS, None)
    if groups is None:
        import torch.distributed as dist
        ranks = mesh.mesh.reshape(-1, model_size(mesh))
        groups = [dist.new_group(ranks[:, j].tolist())
                  for j in range(ranks.shape[1])]
        setattr(mesh, _LEARNER_GROUPS, groups)
    return groups[model_rank(mesh)]
