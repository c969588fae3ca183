"""Learning-rate schedules of the paper's recipes and the controller-driven
scale adapter — the port of ``repro/optim/schedules.py``.

A schedule maps a step counter (a tensor: (n,) for stacked states) to a
float32 multiplier of the same shape, on the counter's device.
"""
from __future__ import annotations

import torch

from ..tree import tree_leaves, tree_map
from .base import FusedSGD, Optimizer, n_learners_of, per_learner


def _steps(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant_schedule(value: float = 1.0):
    return lambda step: torch.full(torch.as_tensor(step).shape, value,
                                   dtype=torch.float32,
                                   device=torch.as_tensor(step).device)


def linear_warmup(warmup_steps: int, peak: float = 1.0, base: float = 0.0):
    def f(step):
        frac = torch.clamp(_steps(step) / max(warmup_steps, 1), max=1.0)
        return base + (peak - base) * frac
    return f


def step_decay(boundaries, values):
    """Piecewise-constant: the paper's CIFAR schedule (0.1 / 0.01 / 0.001)."""
    def f(step):
        s = torch.as_tensor(step)
        bs = torch.as_tensor(boundaries, device=s.device)
        vs = torch.as_tensor(values, dtype=torch.float32, device=s.device)
        return vs[torch.sum(s[..., None] >= bs, dim=-1)]
    return f


def warmup_linear_scale(warmup_steps: int, scale: float,
                        anneal_boundaries=(), anneal_factor: float = 0.1):
    """Goyal et al. large-batch recipe: warm up from 1x to ``scale``x over
    ``warmup_steps``, then multiply by ``anneal_factor`` at each boundary."""
    def f(step):
        s = _steps(step)
        warm = 1.0 + (scale - 1.0) * torch.clamp(s / max(warmup_steps, 1),
                                                 max=1.0)
        if len(anneal_boundaries):
            st = torch.as_tensor(step)
            bs = torch.as_tensor(anneal_boundaries, device=st.device)
            n = torch.sum(st[..., None] >= bs, dim=-1).to(torch.float32)
            warm = warm * anneal_factor ** n
        return warm
    return f


def scale_by_controller(opt: Optimizer) -> Optimizer:
    """Wrap an optimizer so its updates are multiplied by a mutable scale
    that lives in the optimizer state, (n,) float32, written between steps
    with ``set_controller_scale``.  The fused path hands it to the kernel
    in the coefficient table: a scale write changes a tensor operand,
    never a launch argument."""
    def init(params):
        leaf = tree_leaves(params)[0]
        return {"inner": opt.init(params),
                "scale": torch.ones((n_learners_of(params),),
                                    dtype=torch.float32, device=leaf.device)}

    def update(grads, state, params, *extra):
        upd, inner = opt.update(grads, state["inner"], params, *extra)
        upd = tree_map(lambda u: per_learner(state["scale"], u) * u, upd)
        return upd, {"inner": inner, "scale": state["scale"]}

    fused = None
    if opt.fused is not None:
        f = opt.fused
        fused = FusedSGD(
            lr=f.lr, beta=f.beta, weight_decay=f.weight_decay,
            read_mu=lambda s: f.read_mu(s["inner"]),
            write_mu=lambda s, mu: {**s, "inner": f.write_mu(s["inner"], mu)},
            scale=lambda s: s["scale"] * f.scale(s["inner"]),
            bump=lambda s: {**s, "inner": f.bump(s["inner"])})
    return Optimizer(init, update, wants_mixed=opt.wants_mixed, fused=fused,
                     layout_sensitive=opt.layout_sensitive,
                     static_mixing_only=opt.static_mixing_only)


def set_controller_scale(opt_state, scale):
    """Write the controller's multiplier into a stacked scale_by_controller
    state (descends through ``"inner"`` wrappers, either wrap order)."""
    if "scale" in opt_state:
        s = opt_state["scale"]
        new = torch.broadcast_to(
            torch.as_tensor(scale, dtype=s.dtype, device=s.device),
            s.shape).clone()
        return {**opt_state, "scale": new}
    if "inner" in opt_state:
        return {**opt_state,
                "inner": set_controller_scale(opt_state["inner"], scale)}
    raise KeyError("no scale_by_controller layer in this optimizer state")


def controller_scale(opt_state) -> torch.Tensor:
    """Read back the current (n,) multiplier."""
    if "scale" in opt_state:
        return opt_state["scale"]
    if "inner" in opt_state:
        return controller_scale(opt_state["inner"])
    raise KeyError("no scale_by_controller layer in this optimizer state")
