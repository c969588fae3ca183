"""The paper's analysis instruments (Sec. 2 + Appendix B) — the port of
``repro/core/diagnostics.py``.

Definitions (over all parameters):

  w_a        = (1/n) sum_j w_j                      average weight
  g          = grad L(w_a)  over the SUPERBATCH mu  "true" direction
  g_j        = grad L^{mu_j}(w_j)                   per-learner gradient
  g_a        = (1/n) sum_j g_j
  alpha_e    = alpha * (g_a . g) / ||g||^2          effective learning rate
  eta_perp   = -alpha g_a + alpha_e g               orthogonal noise
  Delta      = ||eta_perp||^2                       noise strength
  Delta_S    = alpha^2 sum_j ||g_j(w_a) - g0||^2 / (n(n-1))   SSGD noise
               (App. B: alpha^2 sigma_mb^2 / n with the unbiased sample
               estimate of the minibatch-gradient variance)
  Delta2     = alpha^2 ||(1/n) sum_j [grad L^{mu_j}(w_j)
                                    - grad L^{mu_j}(w_a)]||^2
  sigma_w^2  = Tr(C) = sum_l (1/n) sum_j (w_jl - w_al)^2   weight variance

They cost 2n forward/backward passes (at the local weights and at w_a),
one learner at a time, so run them at probe cadence
(``MultiLearnerTrainer.diagnostics`` through ``add_probe``).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..tree import tree_leaves, tree_map
from .util import (learner_mean, learner_var, tree_dot, tree_norm_sq,
                   tree_scale, tree_sub, value_and_grad)

__all__ = ["DiagStats", "compute_diagnostics"]


class DiagStats(NamedTuple):
    alpha_e: torch.Tensor         # effective learning rate
    sigma_w_sq: torch.Tensor      # weight variance Tr(C)
    delta_total: torch.Tensor     # ||eta_perp||^2
    delta_s: torch.Tensor         # SSGD (minibatch) noise component
    delta_2: torch.Tensor         # landscape-dependent DPSGD component (Eq. 5)
    grad_norm: torch.Tensor       # ||g|| at w_a over the superbatch
    ga_norm: torch.Tensor         # ||g_a||
    loss_at_mean: torch.Tensor
    consensus_dist: torch.Tensor  # sqrt((1/n) sum_j ||w_j - w_a||^2)
    staleness_mean: torch.Tensor  # mean per-learner buffer age (adpsgd)
    staleness_max: torch.Tensor   # max per-learner buffer age (adpsgd)


def _mean(trees):
    return tree_map(lambda *xs: torch.mean(torch.stack(xs), dim=0), *trees)


def compute_diagnostics(loss_fn: Callable, stacked_params, stacked_batch,
                        alpha, age=None, *,
                        params_from_tree: Optional[Callable] = None
                        ) -> DiagStats:
    """loss_fn(params, batch) -> scalar loss for ONE learner's minibatch.

    stacked_params: leaves (n, ...); stacked_batch: leaves (n, B, ...).
    ``age`` is AD-PSGD's (n,) per-learner buffer age; None for the
    synchronous algorithms.  ``params_from_tree`` as in
    ``core.util.bind_params``."""
    n = tree_leaves(stacked_params)[0].shape[0]

    def shard(tree, j):
        return tree_map(lambda x: x[j], tree)

    w_a = learner_mean(stacked_params)
    # g_j at the local weights w_j (DPSGD gradients)
    g_a = _mean([value_and_grad(loss_fn, shard(stacked_params, j),
                                shard(stacked_batch, j),
                                params_from_tree)[1] for j in range(n)])
    # g_j at the mean weights (SSGD gradients); their mean is the
    # superbatch gradient g0 = g
    at_mean = [value_and_grad(loss_fn, w_a, shard(stacked_batch, j),
                              params_from_tree) for j in range(n)]
    losses = torch.stack([loss for loss, _ in at_mean])
    g_at_mean = [g for _, g in at_mean]
    del at_mean
    g0 = _mean(g_at_mean)
    g = g0

    g_norm_sq = tree_norm_sq(g)
    safe = torch.clamp_min(g_norm_sq, 1e-30)
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=safe.device)
    alpha_e = alpha * tree_dot(g_a, g) / safe

    eta = tree_sub(tree_scale(alpha_e, g), tree_scale(alpha, g_a))
    delta_total = tree_norm_sq(eta)
    del eta

    # Delta_S (App. B), unbiased: alpha^2 sum_j ||g_j(w_a) - g0||^2 /
    # (n (n-1)) — g0 is the mean OF the g_j, so the naive mean of the
    # squared deviations underestimates sigma_mb^2 by (n-1)/n
    per = torch.stack([tree_norm_sq(tree_sub(gj, g0)) for gj in g_at_mean])
    delta_s = alpha ** 2 * torch.sum(per) / (n * max(n - 1, 1))

    # Delta^(2): gradients moved by the weight spread (Eq. 5 numerator)
    delta_2 = alpha ** 2 * tree_norm_sq(tree_sub(g_a, g0))

    sigma_w_sq = learner_var(stacked_params)
    if age is None:
        stale_mean = stale_max = torch.zeros((), device=safe.device)
    else:
        stale_mean = torch.mean(age.float())
        stale_max = torch.max(age).float()

    return DiagStats(
        alpha_e=alpha_e,
        sigma_w_sq=sigma_w_sq,
        delta_total=delta_total,
        delta_s=delta_s,
        delta_2=delta_2,
        grad_norm=torch.sqrt(g_norm_sq),
        ga_norm=torch.sqrt(tree_norm_sq(g_a)),
        loss_at_mean=torch.mean(losses),
        # sigma_w_sq IS the squared consensus distance
        consensus_dist=torch.sqrt(sigma_w_sq),
        staleness_mean=stale_mean,
        staleness_max=stale_max,
    )
