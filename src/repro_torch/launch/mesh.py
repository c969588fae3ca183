"""The learner group: the port of ``repro/launch/mesh.py``'s learner half.

The reference's learners are the non-``model`` axes of a device mesh
(``learner_axes``, ``n_learners``).  Here the learner axis is a
``torch.distributed`` process group with one learner per rank: rank i
holds learner i's flat store, and gossip is point-to-point between ranks
(``core/dpsgd.py``'s collective half).  The ``model`` axis — tensor
parallelism inside a learner, the reference's sharding rules — is slice
7b and is not here.

Nothing here reads a cluster from the environment: the caller gives the
group its address, size and rank (``init_learner_group``), as
``torch.distributed`` needs on a machine that tells a program nothing of a
cluster.
"""
from __future__ import annotations

import datetime
from typing import Optional

import torch

from ..device import resolve_device

__all__ = ["init_learner_group", "n_learners", "learner_rank"]


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


def n_learners(group=None) -> int:
    """The learner count: the group's size."""
    import torch.distributed as dist
    return dist.get_world_size(group)


def learner_rank(group=None) -> int:
    """This process's learner: its rank in the group."""
    import torch.distributed as dist
    return dist.get_rank(group)
