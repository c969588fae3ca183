"""Eq. 4 effective-learning-rate prediction from measured curvature — the
port of ``repro/landscape/predictor.py``.

The paper *measures* alpha_e = alpha (g_a . g) / ||g||^2
(``core/diagnostics``); this *predicts* it from the probe quantities:

    alpha_e ~= alpha * (1 - (alpha / 2) * Tr(H C) / sigma_w^2)        (Eq. 4)

Tr(H C) / Tr(C) is the covariance-weighted mean curvature h_eff the
learner cloud samples.  Where the learners have not spread (sigma_w^2 ~ 0,
SSGD) the prediction is alpha, not 0/0.
"""
from __future__ import annotations

import torch

__all__ = ["effective_curvature", "predict_alpha_e"]


def _f32(x, like=None) -> torch.Tensor:
    dev = like.device if isinstance(like, torch.Tensor) else None
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def effective_curvature(trace_hc, sigma_w_sq, eps: float = 1e-12):
    """h_eff = Tr(H C) / Tr(C); 0 when the learners have not spread."""
    trace_hc = _f32(trace_hc)
    sigma_w_sq = _f32(sigma_w_sq, trace_hc)
    return torch.where(sigma_w_sq > eps,
                       trace_hc / torch.clamp_min(sigma_w_sq, eps),
                       torch.zeros_like(trace_hc))


def predict_alpha_e(alpha, trace_hc, sigma_w_sq, eps: float = 1e-12):
    """Paper Eq. 4: alpha_e ~= alpha (1 - (alpha/2) Tr(H C) / sigma_w^2)."""
    h = effective_curvature(trace_hc, sigma_w_sq, eps)
    alpha = _f32(alpha, h)
    return alpha * (1.0 - 0.5 * alpha * h)
