"""Optimizer protocol and the fused-SGD recipe — the port of
``repro/optim/base.py``.

An optimizer is a pair of functions over STACKED states: every leaf of
params, grads and state carries a leading learner axis n, and per-learner
scalars (step counters, controller scales) are (n,) tensors.  That is what
the reference obtains by vmapping its update over learners; here the
update is written once for the whole fleet.

    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    new_params = apply_updates(params, updates)     # params + updates
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from ..tree import tree_leaves, tree_map


def n_learners_of(params) -> int:
    """The learner count of a stacked tree (its leading axis)."""
    return tree_leaves(params)[0].shape[0]


def per_learner(s, like: torch.Tensor):
    """Broadcast a per-learner (n,) scalar against a stacked leaf; scalars
    and Python numbers pass through."""
    if isinstance(s, torch.Tensor) and s.dim() == 1:
        return s.reshape((-1,) + (1,) * (like.dim() - 1))
    return s


@dataclasses.dataclass(frozen=True)
class FusedSGD:
    """Static recipe for the fused flat-engine update.

    An optimizer that is exactly momentum-SGD (optionally weight-decayed
    and scaled by schedule/controller multipliers) runs inside the batched
    gossip kernel.  ``lr``, ``beta`` and ``weight_decay`` are launch
    arguments; everything state-dependent flows through these accessors so
    wrappers compose:

      read_mu / write_mu — the momentum buffer inside the optimizer state;
        read_mu returns None for momentum-free SGD.
      scale — the lr multiplier, (n,) for stacked states, or a number; the
        kernel reads it from its coefficient table (a tensor operand).
      bump — advance any step counters (the momentum write is separate).
    """
    lr: float
    beta: float = 0.0
    weight_decay: float = 0.0
    read_mu: Callable[[Any], Any] = lambda s: None
    write_mu: Callable[[Any, Any], Any] = lambda s, mu: s
    scale: Callable[[Any], Any] = lambda s: 1.0
    bump: Callable[[Any], Any] = lambda s: s


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., Any]  # (grads, state, params) -> (updates, state)
    # decentralized-aware optimizers also receive the post-gossip weights
    wants_mixed: bool = False
    # non-None when the update may be fused into the gossip kernel
    fused: Optional[FusedSGD] = None
    # True when the update depends on the per-leaf structure (the flat
    # engine would collapse it to one leaf)
    layout_sensitive: bool = False
    # True when the update is only stable under a static mixing matrix
    static_mixing_only: bool = False


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def scale_by_schedule(opt: Optimizer, schedule) -> Optimizer:
    """Wrap an optimizer so its lr is multiplied by schedule(step).  State
    grows an (n,) int32 step counter."""
    def init(params):
        leaf = tree_leaves(params)[0]
        return {"inner": opt.init(params),
                "step": torch.zeros((n_learners_of(params),),
                                    dtype=torch.int32, device=leaf.device)}

    def update(grads, state, params, *extra):
        scale = schedule(state["step"])
        upd, inner = opt.update(grads, state["inner"], params, *extra)
        upd = tree_map(lambda u: per_learner(scale, u) * u, upd)
        return upd, {"inner": inner, "step": state["step"] + 1}

    fused = None
    if opt.fused is not None:
        f = opt.fused
        fused = FusedSGD(
            lr=f.lr, beta=f.beta, weight_decay=f.weight_decay,
            read_mu=lambda s: f.read_mu(s["inner"]),
            write_mu=lambda s, mu: {**s, "inner": f.write_mu(s["inner"], mu)},
            scale=lambda s: schedule(s["step"]) * f.scale(s["inner"]),
            bump=lambda s: {**s, "inner": f.bump(s["inner"]),
                            "step": s["step"] + 1})
    return Optimizer(init, update, wants_mixed=opt.wants_mixed, fused=fused,
                     layout_sensitive=opt.layout_sensitive,
                     static_mixing_only=opt.static_mixing_only)
