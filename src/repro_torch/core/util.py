"""Tree algebra and learner statistics — the port of ``repro/core/util.py``
(the tree walking itself is ``repro_torch.tree``).  Sums are taken in
float32, leaf by leaf, and folded left to right as the reference's
``tree_reduce`` does.  The masked variants average over the ACTIVE
learners only (elastic membership; the consensus bridge reads them).

``bind_params`` / ``value_and_grad`` differentiate a loss with respect to a
parameter TREE (the reference's layout) for models whose ``loss_fn`` takes
another parameter object (``params_from_tree``, e.g. the transformer's
modules, which hold their own parameter leaves aliasing the tree's
storage).
"""
from __future__ import annotations

from typing import Callable, List, Optional

import torch

from ..tree import tree_leaves, tree_map

__all__ = ["tree_dot", "tree_norm_sq", "tree_add", "tree_sub", "tree_scale",
           "tree_zeros_like", "tree_gaussian_like", "learner_mean",
           "learner_var", "masked_learner_mean", "masked_learner_var",
           "global_norm", "bind_params", "write_leaves", "value_and_grad"]


def _fold(parts):
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def tree_dot(a, b) -> torch.Tensor:
    return _fold([torch.sum(x.float() * y.float())
                  for x, y in zip(tree_leaves(a), tree_leaves(b))])


def tree_norm_sq(a) -> torch.Tensor:
    return tree_dot(a, a)


def global_norm(a) -> torch.Tensor:
    """sqrt of ``tree_norm_sq``: float32 sums, folded left to right."""
    return torch.sqrt(tree_norm_sq(a))


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_sub(a, b):
    return tree_map(torch.sub, a, b)


def tree_scale(s, a):
    return tree_map(lambda x: s * x, a)


def tree_zeros_like(a):
    return tree_map(torch.zeros_like, a)


def gaussian_leaf(gen: torch.Generator, shape, dtype, std: float):
    """One leaf of ``tree_gaussian_like``'s draw."""
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=dtype).mul_(std)


def tree_gaussian_like(gen: torch.Generator, a, std: float):
    """iid N(0, std^2) noise with the structure, shapes and dtypes of
    ``a``, drawn leaf by leaf from ``gen`` on ``gen.device`` (the
    reference's law; its ``jax.random`` draws differ)."""
    return tree_map(lambda x: gaussian_leaf(gen, x.shape, x.dtype, std), a)


def learner_mean(stacked):
    """Mean over the leading learner axis of every leaf:
    w_a = (1/n) sum_j w_j."""
    return tree_map(lambda x: torch.mean(x, dim=0), stacked)


def learner_var(stacked):
    """sigma_w^2 = Tr(C) summed over all parameters: the total (population)
    variance of the learner weights around their mean."""
    return _fold([torch.sum(torch.var(x.float(), dim=0, correction=0))
                  for x in tree_leaves(stacked)])


def _mask_for(active, x):
    return torch.as_tensor(active, dtype=torch.bool, device=x.device
                           ).reshape((-1,) + (1,) * (x.dim() - 1))


def _n_active(active) -> torch.Tensor:
    return torch.clamp(torch.sum(torch.as_tensor(active, dtype=torch.bool)),
                       min=1)


def masked_learner_mean(stacked, active):
    """Consensus mean over the ACTIVE learners only.  ``active``: (n,)
    bool.  Dead rows are excluded with ``where``, never multiplied, so a
    non-finite parked row cannot leak into the mean."""
    def _mean(x):
        s = torch.sum(torch.where(_mask_for(active, x), x.float(), 0.0),
                      dim=0)
        return (s / _n_active(active).to(x.device)).to(x.dtype)
    return tree_map(_mean, stacked)


def masked_learner_var(stacked, active):
    """sigma_w^2 over the ACTIVE learners only (see masked_learner_mean)."""
    def _var(x):
        m = _mask_for(active, x)
        denom = _n_active(active).to(x.device)
        xf = torch.where(m, x.float(), 0.0)
        mean = torch.sum(xf, dim=0) / denom
        dev = torch.where(m, xf - mean[None], 0.0)
        return torch.sum(torch.square(dev)) / denom
    return _fold([_var(x) for x in tree_leaves(stacked)])


def bind_params(tree, params_from_tree: Optional[Callable] = None):
    """-> (the params object ``loss_fn`` takes, built around ``tree``'s
    tensors, and its leaf tensors in a fixed order).  Two trees of one
    structure give their leaves in the same order, so a list of leaf
    gradients lines up with the leaves of ``bind_params(other)``; writing
    into those leaves writes into ``other``'s storage."""
    if params_from_tree is None:
        return tree, tree_leaves(tree)
    params = params_from_tree(tree)
    return params, list(params.parameters())


def write_leaves(like, leaves: List[torch.Tensor],
                 params_from_tree: Optional[Callable] = None, out=None):
    """A tree shaped like ``like`` holding ``leaves`` (in ``bind_params``
    order): ``out`` when given (e.g. views of a flat buffer), else fresh."""
    if out is None:
        out = tree_map(torch.zeros_like, like)
    _, slots = bind_params(out, params_from_tree)
    with torch.no_grad():
        for s, x in zip(slots, leaves):
            s.copy_(x)
    return out


def value_and_grad(loss_fn: Callable, tree, batch,
                   params_from_tree: Optional[Callable] = None):
    """(loss, gradient tree) of ``loss_fn(params, batch)`` at the parameter
    tree ``tree`` (detached; ``tree`` itself is not touched).  A leaf the
    loss never reads (an xLSTM layer's ``norm1``) has a zero gradient, as
    in the reference."""
    with torch.enable_grad():
        w = tree_map(lambda x: x.detach().requires_grad_(), tree)
        params, leaves = bind_params(w, params_from_tree)
        loss = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(leaves, grads)]
    return loss.detach(), write_leaves(tree, grads, params_from_tree)
