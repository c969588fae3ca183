"""Adam / AdamW — the port of ``repro/optim/adam.py``, over stacked
states: the step counter ``t`` is (n,) int32, one per learner, as the
reference's vmapped state is."""
from __future__ import annotations

import torch

from ..tree import tree_leaves, tree_map
from .base import Optimizer, n_learners_of, per_learner


def _zeros_f32(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


def _moments(grads, state, b1: float, b2: float):
    """The updated first and second moments, the step counter and the
    (n,) bias corrections (1 - b1^t, 1 - b2^t)."""
    t = state["t"] + 1
    m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.to(torch.float32),
                 state["m"], grads)
    v = tree_map(lambda v_, g: b2 * v_ + (1 - b2)
                 * torch.square(g.to(torch.float32)), state["v"], grads)
    tf = t.to(torch.float32)
    return m, v, t, 1 - b1 ** tf, 1 - b2 ** tf


def init_moments(params):
    leaf = tree_leaves(params)[0]
    return {"m": _zeros_f32(params), "v": _zeros_f32(params),
            "t": torch.zeros((n_learners_of(params),), dtype=torch.int32,
                             device=leaf.device)}


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    """Adam / AdamW (decoupled decay when weight_decay > 0)."""

    def update(grads, state, params):
        m, v, t, bc1, bc2 = _moments(grads, state, b1, b2)

        def _upd(m_, v_, p):
            step = ((m_ / per_learner(bc1, m_))
                    / (torch.sqrt(v_ / per_learner(bc2, v_)) + eps))
            if weight_decay:
                step = step + weight_decay * p.to(torch.float32)
            return -lr * step
        return tree_map(_upd, m, v, params), {"m": m, "v": v, "t": t}

    return Optimizer(init_moments, update)
