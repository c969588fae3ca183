"""Multi-learner update rules, the single-device half — the port of
``repro/core/dpsgd.py``.

All functions operate on stacked trees (or single tensors) whose leaves
carry a leading learner axis of size n.  One DPSGD step (paper Eq. 2,
"mix then descend"):

    g_j   = grad L^{mu_j}(w_j)            # gradient at the LOCAL weights
    w_s,j = sum_k M_jk w_k                # gossip average of neighbours
    w_j   <- w_s,j - alpha * g_j

SSGD (Eq. 1): g_j = grad L^{mu_j}(w_a); w_a <- w_a - alpha * mean_j g_j.
SSGD* takes SSGD's gradients at w_a + delta_j, delta_j ~ N(0, sigma0^2 I)
(``perturb_weights``).  AD-PSGD averages with a partner's possibly stale
published weights (see ``core/trainer.py``).  The collective (multi-GPU)
gossip helpers arrive with the launch slice (ROADMAP slice 7).
``member_active_mask`` is the elastic fleet's generalization of the
injected straggler (``core/membership.py``).
"""
from __future__ import annotations

import dataclasses

import torch

from ..tree import tree_leaves, tree_map
from .util import learner_mean, tree_add, tree_gaussian_like

__all__ = ["AlgoConfig", "mix_einsum", "mix_pair_gather",
           "straggler_active_mask", "member_active_mask", "perturb_weights",
           "mean_broadcast"]


@dataclasses.dataclass(frozen=True)
class AlgoConfig:
    """How the learners talk to each other (same fields and defaults as
    the reference).  Invalid combinations raise ``ValueError`` where the
    reference asserts."""
    algo: str = "dpsgd"            # dpsgd | ssgd | ssgd_star | adpsgd
    topology: str = "random_pair"  # see core/schedule.SCHEDULED_TOPOLOGIES
    gossip_backend: str = "einsum"  # einsum | ppermute
    gossip_order: str = "mix_then_descend"  # paper Eq. 2; or descend_then_mix
    noise_std: float = 0.01        # sigma_0 for ssgd_star
    n_learners: int = 16
    gossip_rounds: int = 1         # mixing rounds per step (random_matching)
    # -- adpsgd only --------------------------------------------------------
    max_staleness: int = 0         # staleness bound tau (ticks); 0 == sync
    slow_learner: int = -1         # index of the injected straggler (-1: none)
    slow_factor: int = 1           # straggler finishes a step every k ticks

    def __post_init__(self):
        def need(cond, msg):
            if not cond:
                raise ValueError(msg)
        need(self.algo in ("dpsgd", "ssgd", "ssgd_star", "adpsgd"),
             f"unknown algo {self.algo!r}")
        need(self.gossip_order in ("mix_then_descend", "descend_then_mix"),
             f"unknown gossip_order {self.gossip_order!r}")
        need(self.gossip_backend in ("einsum", "ppermute"),
             f"unknown gossip_backend {self.gossip_backend!r}")
        need(self.gossip_rounds >= 1, f"gossip_rounds={self.gossip_rounds}")
        need(self.gossip_rounds == 1 or self.topology == "random_matching",
             "gossip_rounds only parameterizes random_matching — other "
             "schedules fix their own round structure (it would be "
             "silently ignored)")
        need(self.max_staleness >= 0, f"max_staleness={self.max_staleness}")
        need(self.slow_factor >= 1, f"slow_factor={self.slow_factor}")
        need(-1 <= self.slow_learner < self.n_learners,
             f"slow_learner={self.slow_learner}")
        if self.algo == "adpsgd":
            need(self.topology == "random_pair",
                 "adpsgd gossips pairwise; use topology='random_pair'")
            need(self.gossip_order == "mix_then_descend",
                 "adpsgd only supports the paper Eq. 2 ordering")
            need(self.gossip_rounds == 1,
                 "adpsgd's async tick is one pairwise exchange")


def mix_einsum(stacked, m: torch.Tensor):
    """w_i <- sum_j M_ij w_j applied to every leaf, in float32."""
    def _mix(x):
        out = torch.einsum("ij,j...->i...", m.to(torch.float32),
                           x.to(torch.float32))
        return out.to(x.dtype)
    return tree_map(_mix, stacked)


def mix_pair_gather(stacked, partner: torch.Tensor, remote=None):
    """w_i <- 0.5 (w_i + remote[partner_i]); solo learners keep w_i
    bitwise.  ``remote`` defaults to ``stacked`` (synchronous pairwise
    DPSGD); AD-PSGD passes the stale published buffer."""
    if remote is None:
        remote = stacked
    p = partner.long()

    def _mix(x, r):
        solo = p == torch.arange(x.shape[0], device=x.device)
        mask = solo.reshape((-1,) + (1,) * (x.dim() - 1))
        half = 0.5 * (x + r[p])
        return torch.where(mask, x, half).to(x.dtype)
    return tree_map(_mix, stacked, remote)


def straggler_active_mask(step: int, n: int, slow_learner: int,
                          slow_factor: int, device=None) -> torch.Tensor:
    """(n,) bool: which learners complete a local step this tick.  The
    injected straggler is active only when ``step % slow_factor == 0``;
    ``slow_learner < 0`` or ``slow_factor == 1`` makes everyone active.
    ``step`` is a host int, so the mask is built on ``device`` with no
    host-device copy."""
    if slow_learner < 0 or slow_factor == 1:
        return torch.ones((n,), dtype=torch.bool, device=device)
    idx = torch.arange(n, device=device)
    return (idx != slow_learner) | (step % slow_factor == 0)


def member_active_mask(step: int, active: torch.Tensor,
                       slow_every: torch.Tensor) -> torch.Tensor:
    """(n,) bool: which fleet members complete a local step this tick.

    The elastic generalization of ``straggler_active_mask``: every learner
    carries a ``slow_every`` tick divisor (1 = full speed, k = one
    completed step per k ticks, ``membership.HUNG`` = wedged) and a
    liveness bit.  Dead learners are never active; ``slow_every[i] ==
    slow_factor`` reproduces the injected straggler's law bitwise
    (``step % k == 0``).  ``step`` is a host int and ``active`` /
    ``slow_every`` device tensors, so the mask is built where they live
    with no host sync."""
    se = torch.clamp(slow_every.to(torch.int32), min=1)
    gate = (se <= 1) | (torch.remainder(step, se) == 0)
    return active.to(torch.bool) & gate


def perturb_weights(gen: torch.Generator, params, std: float):
    """SSGD*: w + delta, delta ~ N(0, std^2 I) drawn leaf by leaf from
    ``gen`` (the reference's law; its ``jax.random`` draws differ)."""
    return tree_add(params, tree_gaussian_like(gen, params, std))


def mean_broadcast(stacked):
    """Every learner's weights replaced by the global average (SSGD sync);
    each leaf is an expanded view of the mean."""
    mean = learner_mean(stacked)
    n = tree_leaves(stacked)[0].shape[0]
    return tree_map(lambda m: m[None].expand((n,) + tuple(m.shape)), mean)
