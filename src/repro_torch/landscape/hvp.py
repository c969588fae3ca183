"""Hessian-vector products and stochastic trace estimators — the port of
``repro/landscape/hvp.py`` (DESIGN §10).

  hvp(loss, p, v)     = H(p) v       reverse over reverse
  hutchinson_trace    ~ Tr(H)        Rademacher probes
  trace_hc            = Tr(H C)      EXACT given the sample:
      C = (1/n) sum_j d_j d_j^T with d_j = w_j - w_a, so
      Tr(H C) = (1/n) sum_j d_j^T H d_j — the learner deviations are the
      probe vectors.

Parameters and vectors are trees in the reference's layout.  A model
whose ``loss_fn`` takes another parameter object passes
``params_from_tree`` (the transformer's ``api.params_from_tree``); its
leaves are then the object's own parameter tensors, which alias the tree
(``core.util.bind_params``).

The reference's HVP is forward over reverse (``jax.jvp`` of
``jax.grad``).  Here it is reverse over reverse:
``torch.autograd.grad(loss, leaves, create_graph=True)`` gives g with its
graph, then the gradient of <g, v> is H v.  Chosen because it works on
the parameter objects the port's models already take (``torch.func``'s
transforms would need the models rewritten as functional calls), runs
through every op on the models' paths (all plain torch, the chunked
attention included), and costs about what the jvp does: one forward and
two backward passes.  The reference ``vmap``s over the n learner shards of
the superbatch; here a loop accumulates (1/n) sum_j H_j v, so only one
shard's double-backward graph is alive at a time — at full width that is
what keeps a probe's memory at one shard's activations.

Random probes take a ``torch.Generator`` (the reference's law, not its
``jax.random`` draws) and an injection argument, so a test can hand both
packages the same vectors.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from ..core.util import (bind_params, learner_mean, tree_dot, tree_sub,
                         write_leaves)
from ..tree import tree_leaves, tree_map

__all__ = ["hvp", "make_hvp_fn", "superbatch_loss_fn", "hutchinson_trace",
           "trace_hc", "tree_rademacher_like"]


def _n_shards(stacked_batch) -> int:
    return tree_leaves(stacked_batch)[0].shape[0]


def _shard(stacked, j: int):
    return tree_map(lambda x: x[j], stacked)


def superbatch_loss_fn(loss_fn: Callable, stacked_batch) -> Callable:
    """params -> mean over the n learner minibatches of loss_fn(params,
    b_j): the L whose Hessian the paper's analysis uses."""
    n = _n_shards(stacked_batch)

    def f(params):
        return torch.mean(torch.stack([
            loss_fn(params, _shard(stacked_batch, j)) for j in range(n)]))
    return f


def _hvp_leaves(loss: torch.Tensor, leaves: Sequence[torch.Tensor],
                vleaves: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """H v for the leaves of ``loss``'s graph: the gradient of <g, v>."""
    g = torch.autograd.grad(loss, leaves, create_graph=True,
                            allow_unused=True)
    parts = [torch.sum(gi * vi) for gi, vi in zip(g, vleaves)
             if gi is not None and gi.requires_grad]
    if not parts:                    # the loss is linear in every leaf
        return [torch.zeros_like(x) for x in leaves]
    hv = torch.autograd.grad(sum(parts), leaves, allow_unused=True)
    return [torch.zeros_like(x) if h is None else h
            for x, h in zip(leaves, hv)]


def _detached(tree, params_from_tree):
    return [v.detach() for v in bind_params(tree, params_from_tree)[1]]


def hvp(loss: Callable, params, vector, *,
        params_from_tree: Optional[Callable] = None):
    """H(params) @ vector for a scalar ``loss(params_object)``."""
    with torch.enable_grad():
        w = tree_map(lambda x: x.detach().requires_grad_(), params)
        obj, leaves = bind_params(w, params_from_tree)
        hv = _hvp_leaves(loss(obj), leaves,
                         _detached(vector, params_from_tree))
    return write_leaves(params, hv, params_from_tree)


def make_hvp_fn(loss_fn: Callable, params, stacked_batch, *,
                params_from_tree: Optional[Callable] = None) -> Callable:
    """Closure ``matvec(v, out=None)`` -> H v with H at ``params`` over the
    superbatch; ``out``, a tree shaped like ``params``, receives the result
    (e.g. views of a flat buffer)."""
    n = _n_shards(stacked_batch)
    w = tree_map(lambda x: x.detach().requires_grad_(), params)
    obj, leaves = bind_params(w, params_from_tree)

    def matvec(v, out=None):
        vleaves = _detached(v, params_from_tree)
        acc = None
        for j in range(n):
            with torch.enable_grad():
                # the 1/n of the superbatch mean is the cotangent of each
                # shard's loss, as in the reference's grad of the mean
                hv = _hvp_leaves(loss_fn(obj, _shard(stacked_batch, j)) / n,
                                 leaves, vleaves)
            acc = hv if acc is None else [a + h for a, h in zip(acc, hv)]
        return write_leaves(params, acc, params_from_tree, out=out)
    return matvec


def tree_rademacher_like(gen: torch.Generator, tree):
    """iid +-1 float32 probe with the structure and shapes of ``tree``,
    drawn leaf by leaf from ``gen`` on ``gen.device``."""
    return tree_map(lambda x: torch.randint(
        0, 2, x.shape, generator=gen, device=gen.device).float() * 2.0 - 1.0,
        tree)


def hutchinson_trace(loss_fn: Callable, params, stacked_batch,
                     gen: Optional[torch.Generator] = None,
                     n_samples: int = 8, *, probes=None,
                     params_from_tree: Optional[Callable] = None
                     ) -> torch.Tensor:
    """Tr(H) ~ E_z[z^T H z], z Rademacher (unbiased).  ``probes``, a list
    of trees, replaces the ``n_samples`` draws from ``gen``."""
    matvec = make_hvp_fn(loss_fn, params, stacked_batch,
                         params_from_tree=params_from_tree)
    if probes is None:
        probes = [tree_rademacher_like(gen, params)
                  for _ in range(n_samples)]
    return torch.mean(torch.stack([tree_dot(z, matvec(z)) for z in probes]))


def trace_hc(loss_fn: Callable, stacked_params, stacked_batch, *,
             params_from_tree: Optional[Callable] = None) -> torch.Tensor:
    """Tr(H C) = (1/n) sum_j d_j^T H d_j with H at w_a, d_j = w_j - w_a;
    exact in the sample covariance, n HVPs."""
    w_a = learner_mean(stacked_params)
    matvec = make_hvp_fn(loss_fn, w_a, stacked_batch,
                         params_from_tree=params_from_tree)
    n = tree_leaves(stacked_params)[0].shape[0]
    vals = []
    for j in range(n):
        d = tree_sub(_shard(stacked_params, j), w_a)
        vals.append(tree_dot(d, matvec(d)))
    return torch.mean(torch.stack(vals))
