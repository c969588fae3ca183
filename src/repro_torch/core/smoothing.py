"""Theorem-1 instrument: randomized smoothing of the loss landscape — the
port of ``repro/core/smoothing.py``.

Theorem 1: DPSGD implicitly optimizes L~(w) = E_{delta~N(0, sigma_w^2 I)}
[L(w + delta)], and if L is G-Lipschitz then L~ is (2G/sigma_w)-smooth.

  * ``smoothed_loss``: Monte-Carlo estimate of L~
  * ``smoothed_grad``: its gradient, the mean of grad L(w + delta_i)
  * ``estimate_smoothness``: empirical gradient-Lipschitz constant
        l_s ~= max ||grad f(x) - grad f(y)|| / ||x - y||
    over random probe pairs, for L (sigma = 0) or L~ (sigma > 0).

Noise comes from a ``torch.Generator`` (the reference's law, not its
draws).  ``loss_fn`` takes the parameter tree itself (the FC net's dict,
or any model whose parameters are a tree of tensors).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..tree import tree_map
from .util import (tree_add, tree_gaussian_like, tree_norm_sq, tree_sub,
                   value_and_grad)

__all__ = ["smoothed_loss", "smoothed_grad", "estimate_smoothness"]


def smoothed_loss(loss_fn: Callable, params, batch, gen: torch.Generator,
                  sigma: float, n_samples: int = 8):
    """Monte-Carlo L~(w) = E_delta L(w + delta)."""
    return torch.mean(torch.stack([
        loss_fn(tree_add(params, tree_gaussian_like(gen, params, sigma)),
                batch) for _ in range(n_samples)]))


def smoothed_grad(loss_fn: Callable, params, batch,
                  gen: Optional[torch.Generator], sigma: float,
                  n_samples: int = 8, *, noise=None):
    """grad L~(w) = E_delta grad L(w + delta), one sample at a time;
    ``noise`` (a list of trees) replaces the draws from ``gen``."""
    if noise is None:
        noise = [tree_gaussian_like(gen, params, sigma)
                 for _ in range(n_samples)]
    grads = [value_and_grad(loss_fn, tree_add(params, d), batch)[1]
             for d in noise]
    return tree_map(lambda *xs: torch.mean(torch.stack(xs), dim=0), *grads)


def estimate_smoothness(loss_fn: Callable, params, batch,
                        gen: torch.Generator, sigma: float = 0.0,
                        n_pairs: int = 8, probe_radius: float = 0.05,
                        n_mc: int = 8) -> torch.Tensor:
    """Empirical l_s = max_i ||g(x_i) - g(y_i)|| / ||x_i - y_i||.

    sigma == 0 probes the raw landscape L; sigma > 0 the smoothed L~, with
    the same Monte-Carlo deltas at x_i and y_i (as the reference reuses
    one key for both)."""
    vals = []
    for _ in range(n_pairs):
        x = tree_add(params, tree_gaussian_like(gen, params, probe_radius))
        y = tree_add(x, tree_gaussian_like(gen, params, probe_radius))
        if sigma == 0.0:
            gx = value_and_grad(loss_fn, x, batch)[1]
            gy = value_and_grad(loss_fn, y, batch)[1]
        else:
            noise = [tree_gaussian_like(gen, params, sigma)
                     for _ in range(n_mc)]
            gx = smoothed_grad(loss_fn, x, batch, None, sigma, noise=noise)
            gy = smoothed_grad(loss_fn, y, batch, None, sigma, noise=noise)
        num = torch.sqrt(tree_norm_sq(tree_sub(gx, gy)))
        den = torch.sqrt(tree_norm_sq(tree_sub(x, y)))
        vals.append(num / torch.clamp_min(den, 1e-12))
    return torch.max(torch.stack(vals))
