"""SGD with (optional) heavy-ball momentum — the paper's optimizer; the
port of ``repro/optim/sgd.py``."""
from __future__ import annotations

import torch

from ..tree import tree_map
from .base import FusedSGD, Optimizer


def sgd(lr: float, momentum: float = 0.0, nesterov: bool = False,
        weight_decay: float = 0.0) -> Optimizer:
    """Heavy-ball (and plain) SGD advertise a FusedSGD recipe so the flat
    engine runs them inside the gossip kernel; the nesterov variant reads
    both mu and g after the accumulate and stays on the unfused path."""

    def init(params):
        if momentum == 0.0:
            return ()
        return {"mu": tree_map(
            lambda p: torch.zeros_like(p, dtype=torch.float32), params)}

    def update(grads, state, params):
        if weight_decay:
            grads = tree_map(lambda g, p: g + weight_decay * p.to(g.dtype),
                             grads, params)
        if momentum == 0.0:
            return tree_map(lambda g: -lr * g, grads), state
        mu = tree_map(lambda m, g: momentum * m + g.to(torch.float32),
                      state["mu"], grads)
        if nesterov:
            upd = tree_map(
                lambda m, g: -lr * (momentum * m + g.to(torch.float32)),
                mu, grads)
        else:
            upd = tree_map(lambda m: -lr * m, mu)
        return upd, {"mu": mu}

    fused = None
    if not nesterov:
        if momentum == 0.0:
            fused = FusedSGD(lr=lr, weight_decay=weight_decay)
        else:
            fused = FusedSGD(lr=lr, beta=momentum, weight_decay=weight_decay,
                             read_mu=lambda s: s["mu"],
                             write_mu=lambda s, mu_new: {"mu": mu_new})
    return Optimizer(init, update, fused=fused)
