"""Landscape probe engine + closed-loop AutoLR controller — the port of
``repro/landscape`` (DESIGN §10).

Layers:
  hvp.py        Hessian-vector products, Hutchinson Tr(H), exact Tr(H C)
  lanczos.py    m-step Lanczos with full reorthogonalization through the
                CUDA kernels of kernels/reorth.py
  predictor.py  Eq. 4 effective-LR prediction from Tr(H C) / sigma_w^2
  probe.py      ProbeSchedule + ProbeResult + probe functions
  autolr.py     AutoLRController: probe results -> clamped LR multiplier
"""
from .autolr import AutoLRController
from .hvp import (hutchinson_trace, hvp, make_hvp_fn, superbatch_loss_fn,
                  trace_hc, tree_rademacher_like)
from .lanczos import LanczosResult, lanczos, lanczos_pytree, sharpness
from .predictor import effective_curvature, predict_alpha_e
from .probe import (ProbeResult, ProbeSchedule, make_probe_fn,
                    make_trainer_probe, probe_landscape)

__all__ = [
    "AutoLRController", "hvp", "make_hvp_fn", "superbatch_loss_fn",
    "hutchinson_trace", "trace_hc", "tree_rademacher_like",
    "LanczosResult", "lanczos", "lanczos_pytree", "sharpness",
    "effective_curvature", "predict_alpha_e",
    "ProbeResult", "ProbeSchedule", "probe_landscape", "make_probe_fn",
    "make_trainer_probe",
]
