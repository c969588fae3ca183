"""AdaScale gain-ratio LR rule, stacked under the AutoLR stability clamp —
the port of ``repro/optim/adascale.py`` (host-side Python in both).

An elastic fleet changes its effective batch size every time membership
changes: n_active learners contribute gradients, so the linear-scaling
heuristic would jump the LR by n_active — and overshoot exactly when the
loss landscape can't take it.  AdaScale (Johnson et al., 2020) replaces
the heuristic with a measured *gain ratio*

    r = (sigma^2 + mu^2) / (sigma^2 / n + mu^2)   in [1, n],

where mu^2 = |E g|^2 is the squared mean-gradient norm and sigma^2 the
total per-learner gradient variance: when learner gradients agree
(mu^2 >> sigma^2) averaging buys nothing and r -> 1; when they are noise
(sigma^2 >> mu^2) averaging over n buys the full r -> n.  Both moments
come free from the trainer's per-step metrics (``grad_sq_mean`` = mean_i
|g_i|^2 and ``grad_norm`` = |mean_i g_i| over the ACTIVE learners) and
are EMA-smoothed.

:class:`AdaScaleAutoLR` composes the gain with the paper's closed-loop
AutoLR controller (``landscape.AutoLRController``) through the same
``scale_by_controller`` seam (``optim.set_controller_scale``): the
emitted multiplier is ``min(gain * autolr_scale, rho / (alpha0 *
sharpness_ema))`` — the AdaScale gain proposes, the curvature clamp
disposes, so ``alpha_eff * lambda_max <= rho < 2`` holds across resizes
by construction (DESIGN §15).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

__all__ = ["AdaScale", "AdaScaleAutoLR"]


@dataclasses.dataclass
class AdaScale:
    """Host-side gain-ratio estimator (per-step ``update``, like the
    AutoLR controller's per-probe one).

    theta: EMA retention for the two moment estimates (0 = trust each
    step fully); eps guards the denominator at exact consensus.
    """
    theta: float = 0.9
    eps: float = 1e-12

    sigma_sq: Optional[float] = None    # EMA'd total gradient variance
    mu_sq: Optional[float] = None       # EMA'd squared mean-grad norm
    gain: float = 1.0                   # last emitted ratio

    def __post_init__(self):
        if not 0.0 <= self.theta < 1.0:
            raise ValueError(f"theta must be in [0, 1), got {self.theta}")

    def update(self, grad_sq_mean: float, grad_norm_sq: float,
               n_active: float) -> float:
        """Consume one step's gradient moments; return the gain in [1, n].

        ``grad_sq_mean`` = mean_i |g_i|^2, ``grad_norm_sq`` = |mean_i g_i|^2
        over the n_active live learners (the trainer's masked metrics).
        """
        n = max(float(n_active), 1.0)
        m2, mb = float(grad_sq_mean), float(grad_norm_sq)
        if not (m2 == m2 and mb == mb):        # NaN probe: hold the gain
            return self.gain
        if n <= 1.0:
            self.gain = 1.0
            return self.gain
        # unbiased moment split: E|g_i|^2 = mu^2 + sigma^2 and
        # E|gbar|^2 = mu^2 + sigma^2/n  =>  solve for (sigma^2, mu^2)
        var = max(m2 - mb, 0.0) * n / (n - 1.0)
        mu = max(mb - var / n, 0.0)
        if self.sigma_sq is None:
            self.sigma_sq, self.mu_sq = var, mu
        else:
            t = self.theta
            self.sigma_sq = t * self.sigma_sq + (1.0 - t) * var
            self.mu_sq = t * self.mu_sq + (1.0 - t) * mu
        r = ((self.sigma_sq + self.mu_sq)
             / (self.sigma_sq / n + self.mu_sq + self.eps))
        self.gain = min(max(r, 1.0), n)
        return self.gain

    def reset_smoothing(self) -> None:
        """Drop the EMA state (call on a resize if the noise regime moved)."""
        self.sigma_sq = self.mu_sq = None


@dataclasses.dataclass
class AdaScaleAutoLR:
    """AdaScale gain stacked UNDER the AutoLR stability clamp.

    ``autolr`` is duck-typed (landscape.AutoLRController or anything with
    ``update(probe)``, ``scale``, ``alpha0``, ``rho``, ``sharpness_ema``,
    ``max_scale``): feed probes to :meth:`on_probe` at probe cadence and
    step metrics to :meth:`on_metrics` every step; write :attr:`scale`
    into the optimizer state with ``set_controller_scale``.
    """
    autolr: Any
    adascale: AdaScale = dataclasses.field(default_factory=AdaScale)
    max_gain: Optional[float] = None    # optional hard cap on the gain

    scale: float = 1.0                  # last composed multiplier

    def on_metrics(self, metrics) -> float:
        """Per-step: fold the fresh gradient moments into the gain.
        ``metrics`` is a trainer StepMetrics (host-fetched)."""
        gn = float(metrics.grad_norm)
        self.adascale.update(float(metrics.grad_sq_mean), gn * gn,
                             float(metrics.n_active))
        return self._compose()

    def on_probe(self, probe) -> float:
        """Probe cadence: refresh the curvature clamp, recompose."""
        self.autolr.update(probe)
        return self._compose()

    def _compose(self) -> float:
        gain = self.adascale.gain
        if self.max_gain is not None:
            gain = min(gain, self.max_gain)
        scale = gain * float(self.autolr.scale)
        # the stability edge binds LAST: alpha0 * scale * lambda <= rho
        ema = self.autolr.sharpness_ema
        if ema is not None and ema > 0.0:
            scale = min(scale, self.autolr.rho / (self.autolr.alpha0 * ema))
        self.scale = max(scale, 0.0)
        return self.scale
