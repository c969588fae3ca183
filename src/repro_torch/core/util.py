"""Learner statistics over stacked trees — the part of
``repro/core/util.py`` the trainer uses (the tree walking itself is
``repro_torch.tree``).  The masked (elastic) variants arrive with ROADMAP
slice 4."""
from __future__ import annotations

import torch

from ..tree import tree_leaves, tree_map

__all__ = ["learner_mean", "learner_var"]


def learner_mean(stacked):
    """Mean over the leading learner axis of every leaf:
    w_a = (1/n) sum_j w_j."""
    return tree_map(lambda x: torch.mean(x, dim=0), stacked)


def learner_var(stacked):
    """sigma_w^2 = Tr(C) summed over all parameters: the total (population)
    variance of the learner weights around their mean."""
    return sum(torch.sum(torch.var(x.float(), dim=0, correction=0))
               for x in tree_leaves(stacked))
