"""LAMB (You et al. 2019) — the paper's SSGD large-batch baseline (Fig. 3);
the port of ``repro/optim/lamb.py``.  Layer-wise trust ratio r = ||p|| /
||adam_step|| per leaf and per learner, so the optimizer is
``layout_sensitive``: the trainer keeps it on the pytree engine."""
from __future__ import annotations

import torch

from ..tree import tree_map
from .adam import _moments, init_moments
from .base import Optimizer, per_learner


def _norm(x: torch.Tensor) -> torch.Tensor:
    """(n,) L2 norm of each learner's row of a stacked leaf."""
    return torch.linalg.vector_norm(x, dim=tuple(range(1, x.dim())))


def lamb(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
         weight_decay: float = 0.01) -> Optimizer:

    def update(grads, state, params):
        m, v, t, bc1, bc2 = _moments(grads, state, b1, b2)

        def _upd(m_, v_, p):
            u = ((m_ / per_learner(bc1, m_))
                 / (torch.sqrt(v_ / per_learner(bc2, v_)) + eps))
            u = u + weight_decay * p.to(torch.float32)
            pn, un = _norm(p.to(torch.float32)), _norm(u)
            trust = torch.where((pn > 0) & (un > 0), pn / un,
                                torch.ones_like(pn))
            return -lr * per_learner(trust, u) * u
        return tree_map(_upd, m, v, params), {"m": m, "v": v, "t": t}

    return Optimizer(init_moments, update, layout_sensitive=True)
