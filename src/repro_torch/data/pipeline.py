"""Per-learner batch pipeline — the port of ``repro/data/pipeline.py``.

Each learner j consumes its own minibatch mu_j(t) (paper Sec. 2).  Learner
j's batch at step t is drawn from a ``torch.Generator`` seeded from
(seed, t, j) on the loader's device, so no two learners see the same
minibatch, a restart replays the identical stream, and a learner's stream
does not depend on the fleet size.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..device import resolve_device
from ..tree import tree_map

_MIX = 1_000_003                         # a prime, to spread the seed parts


def _seed(seed: int, step: int, learner: int) -> int:
    return ((seed * _MIX + step) * _MIX + learner) % (2 ** 63)


def stack_learner_batches(sample_fn: Callable, seed: int, n_learners: int,
                          *args, device=None):
    """Per-learner sampling -> leaves with a leading (n_learners, ...) axis.
    Learner j calls ``sample_fn(gen, *args)`` with a generator on
    ``device`` (default: cuda) seeded from (seed, j) as ``ShardedLoader``
    seeds its step 0, so ``stack_learner_batches(ds.sample, seed, n, B)``
    is ``ShardedLoader(ds, n, B, seed=seed).batch(0)``."""
    gen = torch.Generator(device=resolve_device(device))
    per = [sample_fn(gen.manual_seed(_seed(seed, 0, j)), *args)
           for j in range(n_learners)]
    return tree_map(lambda *xs: torch.stack(xs), *per)


@dataclasses.dataclass
class ShardedLoader:
    dataset: object                 # must expose .sample(gen, batch, *extra)
    n_learners: int
    local_batch: int
    extra_args: tuple = ()
    seed: int = 0
    device: object = None           # None -> cuda (raises without a card)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._gen = torch.Generator(device=self.device)

    def _sample(self, seed: int, size: int):
        self._gen.manual_seed(seed)
        return self.dataset.sample(self._gen, size, *self.extra_args)

    def batch(self, step: int):
        """Stacked batch for all learners at ``step``: leaves
        (n_learners, local_batch, ...)."""
        per = [self._sample(_seed(self.seed, step, j), self.local_batch)
               for j in range(self.n_learners)]
        return {k: torch.stack([b[k] for b in per]) for k in per[0]}

    def eval_batch(self, size: int, tag: int = 0x5EED):
        """A held-out batch (single, unstacked)."""
        return self._sample(_seed(self.seed, -1, tag), size)
