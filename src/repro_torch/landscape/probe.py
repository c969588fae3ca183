"""The landscape probe engine: schedule, measurement bundle, trainer hook —
the port of ``repro/landscape/probe.py``.

A *probe* is a scheduled measurement pass off the training path: sharpness
lambda_max by Lanczos, Tr(H) by Hutchinson, Tr(H C) against the learner
covariance, the gradient noise scale and the Eq. 4 predicted effective
LR.  Probes are plain functions of (params, superbatch, generator); the
``ProbeSchedule`` decides when the host loop calls them
(``MultiLearnerTrainer.add_probe`` / ``run_probes``).  PyTorch runs
eagerly, so ``make_probe_fn`` is a ``functools.partial`` where the
reference jits.

Cost per probe: n fwd/bwd (gradients) + (lanczos_iters + n learners +
hutchinson_samples) HVPs over the n superbatch shards.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, NamedTuple, Optional

import torch

from ..core.util import (learner_mean, learner_var, tree_norm_sq, tree_sub,
                         value_and_grad)
from ..tree import tree_leaves, tree_map
from .hvp import hutchinson_trace, trace_hc
from .lanczos import lanczos_pytree, sharpness
from .predictor import predict_alpha_e

__all__ = ["ProbeSchedule", "ProbeResult", "probe_landscape",
           "make_probe_fn", "make_trainer_probe"]

_MIX = 1_000_003


@dataclasses.dataclass(frozen=True)
class ProbeSchedule:
    """When a probe fires: every ``every`` steps, starting at ``start``;
    ``every=0`` disables it.  The trainer only ever calls ``due(step)``."""
    every: int = 0
    start: int = 0

    def due(self, step: int) -> bool:
        return (self.every > 0 and step >= self.start
                and (step - self.start) % self.every == 0)


class ProbeResult(NamedTuple):
    """One landscape measurement (0-d float32 tensors)."""
    sharpness: torch.Tensor      # lambda_max(H) at w_a (Lanczos)
    trace_h: torch.Tensor        # Tr(H) (Hutchinson)
    trace_hc: torch.Tensor       # Tr(H C) against the learner covariance
    sigma_w_sq: torch.Tensor     # Tr(C) weight variance
    grad_norm: torch.Tensor      # ||g|| at w_a over the superbatch
    gns: torch.Tensor            # gradient noise scale: sigma_mb^2 / ||g||^2
    alpha_e_pred: torch.Tensor   # Eq. 4 prediction (predictor.py)


def probe_landscape(loss_fn: Callable, params, stacked_batch,
                    gen: Optional[torch.Generator] = None, *, alpha: float,
                    lanczos_iters: int = 8, hutchinson_samples: int = 4,
                    reorth: str = "auto",
                    params_from_tree: Optional[Callable] = None, q0=None,
                    probes=None) -> ProbeResult:
    """Measure the landscape at the mean of ``params`` (leaves (n, ...),
    one row per learner) over a superbatch (leaves (n, B, ...)); the
    covariance terms come from the learner spread.  ``gen`` draws the
    Lanczos start vector, then the Hutchinson probes; ``q0`` (a tree) and
    ``probes`` (a list of trees) replace those draws.  (The reference's
    ``stacked=False`` single-replica form serves its launch path, which
    arrives with ROADMAP slice 6.)"""
    pft = params_from_tree
    w_a = learner_mean(params)
    sig_sq = learner_var(params)
    t_hc = trace_hc(loss_fn, params, stacked_batch, params_from_tree=pft)

    # superbatch gradient + per-shard minibatch gradients at w_a
    n = tree_leaves(stacked_batch)[0].shape[0]
    g_shards = [value_and_grad(loss_fn, w_a,
                               tree_map(lambda x: x[j], stacked_batch),
                               pft)[1] for j in range(n)]
    g0 = tree_map(lambda *xs: torch.mean(torch.stack(xs), dim=0), *g_shards)
    g_norm_sq = tree_norm_sq(g0)
    # gradient noise scale: sigma_mb^2 = (1/(n-1)) sum_j ||g_j - g0||^2
    dev_sq = torch.stack([tree_norm_sq(tree_sub(g_j, g0))
                          for g_j in g_shards])
    del g_shards
    gns = (torch.sum(dev_sq) / max(n - 1, 1)
           / torch.clamp_min(g_norm_sq, 1e-30))

    lcz = lanczos_pytree(loss_fn, w_a, stacked_batch, m=lanczos_iters,
                         gen=gen, q0=q0, reorth=reorth,
                         params_from_tree=pft)
    lam = sharpness(lcz)
    del lcz
    t_h = hutchinson_trace(loss_fn, w_a, stacked_batch, gen,
                           n_samples=hutchinson_samples, probes=probes,
                           params_from_tree=pft)
    return ProbeResult(
        sharpness=lam,
        trace_h=t_h,
        trace_hc=t_hc,
        sigma_w_sq=sig_sq,
        grad_norm=torch.sqrt(g_norm_sq),
        gns=gns,
        alpha_e_pred=predict_alpha_e(alpha, t_hc, sig_sq),
    )


def make_probe_fn(loss_fn: Callable, *, alpha: float, lanczos_iters: int = 8,
                  hutchinson_samples: int = 4, reorth: str = "auto",
                  params_from_tree: Optional[Callable] = None) -> Callable:
    """(params, stacked_batch, gen) -> ProbeResult."""
    return partial(probe_landscape, loss_fn, alpha=alpha,
                   lanczos_iters=lanczos_iters,
                   hutchinson_samples=hutchinson_samples, reorth=reorth,
                   params_from_tree=params_from_tree)


def probe_seed(seed: int, step: int) -> int:
    """The probe's generator seed at ``step`` (the reference folds the
    step into its key)."""
    return (seed * _MIX + step) % (2 ** 63)


def make_trainer_probe(loss_fn: Callable, *, alpha: float,
                       lanczos_iters: int = 8, hutchinson_samples: int = 4,
                       seed: int = 0, reorth: str = "auto",
                       params_from_tree: Optional[Callable] = None
                       ) -> Callable:
    """A probe in ``MultiLearnerTrainer`` hook shape: (state view,
    stacked_batch) -> ProbeResult.  The generator is seeded from
    (seed, state.step), so results are reproducible without threading a
    generator through the trainer."""
    core = make_probe_fn(loss_fn, alpha=alpha, lanczos_iters=lanczos_iters,
                         hutchinson_samples=hutchinson_samples,
                         reorth=reorth, params_from_tree=params_from_tree)

    def fn(state, stacked_batch):
        dev = tree_leaves(state.params)[0].device
        gen = torch.Generator(device=dev).manual_seed(
            probe_seed(seed, state.step))
        return core(state.params, stacked_batch, gen)
    return fn
