"""Closed-loop AutoLR: make SSGD's learning rate landscape-dependent — the
port of ``repro/landscape/autolr.py``.

DPSGD self-adjusts its effective LR implicitly (gossip noise shrinks
alpha_e on sharp terrain).  The controller does it explicitly for plain
SSGD, driven by the probe engine (DESIGN §10):

    control law (per probe, at base LR alpha0):
        s_ema  <- ema * s_ema + (1 - ema) * sharpness          (smoothed)
        raw    =  rho / (alpha0 * s_ema)        # target alpha*lambda = rho
        raw    /= 1 + gns_weight * gns          # optional noise backoff
        scale  =  clip(raw, min_scale, max_scale)

rho < 2 keeps the effective step inside the quadratic stability edge; on
smooth terrain the clamp returns the full base LR.  The controller is host
Python state that runs at probe cadence, between steps (its ``float``
reads of the probe are its host syncs); the training step reads the scale
from the optimizer state (``optim.scale_by_controller`` /
``set_controller_scale``).  Invalid settings raise ``ValueError`` where
the reference asserts.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from .probe import ProbeResult

__all__ = ["AutoLRController"]


@dataclasses.dataclass
class AutoLRController:
    """Probe results in, clamped LR multiplier out.

    alpha0:     the base learning rate the wrapped optimizer was built with.
    rho:        target alpha * lambda_max product (< 2, the stability edge).
    min_scale / max_scale: hard clamp on the emitted multiplier.
    ema:        sharpness smoothing (0 = trust each probe fully).
    gns_weight: optional backoff when the gradient noise scale is large.
    """
    alpha0: float
    rho: float = 1.8
    min_scale: float = 0.05
    max_scale: float = 1.0
    ema: float = 0.3
    gns_weight: float = 0.0

    scale: float = 1.0                      # last emitted multiplier
    sharpness_ema: Optional[float] = None   # smoothed lambda_max

    def __post_init__(self):
        if not 0.0 < self.rho < 2.0:
            raise ValueError(f"rho={self.rho} must sit inside the stability "
                             "edge (0, 2)")
        if not 0.0 < self.min_scale <= self.max_scale:
            raise ValueError(f"need 0 < min_scale <= max_scale, got "
                             f"{self.min_scale}, {self.max_scale}")
        if not 0.0 <= self.ema < 1.0:
            raise ValueError(f"ema={self.ema} must lie in [0, 1)")

    def update(self, probe: ProbeResult) -> float:
        """Consume one probe, return the new LR multiplier in [min, max]."""
        s = float(probe.sharpness)
        if self.sharpness_ema is None or not (s == s):   # first probe / nan
            self.sharpness_ema = s if s == s else self.sharpness_ema
        else:
            self.sharpness_ema = (self.ema * self.sharpness_ema
                                  + (1.0 - self.ema) * s)
        if self.sharpness_ema is None or self.sharpness_ema <= 0.0:
            # flat or indefinite probe: nothing to clamp on
            self.scale = self.max_scale
            return self.scale
        raw = self.rho / (self.alpha0 * self.sharpness_ema)
        if self.gns_weight:
            raw /= 1.0 + self.gns_weight * float(probe.gns)
        self.scale = min(max(raw, self.min_scale), self.max_scale)
        return self.scale
