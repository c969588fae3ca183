"""DecentLaM (Yuan et al. 2021, arXiv:2104.11981): momentum-corrected
decentralized SGD — the port of ``repro/optim/decentlam.py``.

Naive decentralized momentum re-accumulates the gossip displacement and
biases the consensus fixed point.  DecentLaM folds the consensus drift
into what the momentum accumulates:

    d_j = g_j + (w_j - mix(w)_j) / lr
    m_j = beta * m_j + d_j
    w_j <- w_j - lr * m_j  ==  mix(w)_j - lr * (beta * m_j_prev + g_j)

The last form is what ``update`` returns: the updates apply to the mixed
weights (``wants_mixed``), as the trainer's "mix then descend" order
applies every optimizer's.  With no gossip (mix(w) == w) it is heavy-ball
SGD.

The exact correction (``drift_scale=1``) assumes a static mixing matrix:
under re-drawn matchings it diverges.  ``drift_scale=1 - momentum`` sums
the momentum's geometric series to one consensus displacement and is
stable under switching.  A drift scale above that threshold marks the
optimizer ``static_mixing_only``, and the trainer refuses a time-varying
schedule; ``unsafe_switching=True`` drops that guard.  The drift divides
by the base lr, so wrap it only in a constant schedule.
"""
from __future__ import annotations

import torch

from ..tree import tree_map
from .base import Optimizer


def decentlam(lr: float, momentum: float = 0.9, weight_decay: float = 0.0,
              drift_scale: float = 1.0,
              unsafe_switching: bool = False) -> Optimizer:
    if not lr > 0.0:
        raise ValueError(f"lr must be positive, got {lr}")
    if not 0.0 <= drift_scale <= 1.0:
        raise ValueError(f"drift_scale must be in [0, 1], got {drift_scale}")
    static_only = (drift_scale > (1.0 - momentum) + 1e-9
                   and not unsafe_switching)

    def init(params):
        return {"mu": tree_map(
            lambda p: torch.zeros_like(p, dtype=torch.float32), params)}

    def update(grads, state, params, mixed=None):
        if weight_decay:
            grads = tree_map(lambda g, p: g + weight_decay * p.to(g.dtype),
                             grads, params)
        upd = tree_map(lambda m, g: -lr * (momentum * m
                                           + g.to(torch.float32)),
                       state["mu"], grads)
        if mixed is None:          # no gossip this step
            mixed = params
        mu = tree_map(
            lambda m, g, w, s: momentum * m + g.to(torch.float32)
            + drift_scale * (w.to(torch.float32) - s.to(torch.float32)) / lr,
            state["mu"], grads, params, mixed)
        return upd, {"mu": mu}

    return Optimizer(init, update, wants_mixed=True,
                     static_mixing_only=static_only)
