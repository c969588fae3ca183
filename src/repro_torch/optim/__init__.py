"""The port's optimizers (stacked, learner-leading states; see ``base``):
``sgd`` (the paper's optimizer, with its fused recipe), ``adam``, ``lamb``
(layer-wise, so ``layout_sensitive``), ``decentlam`` (momentum-corrected
gossip), the host-side ``AdaScale`` / ``AdaScaleAutoLR`` gain rules, and
the schedule and controller wrappers.
"""
from .adam import adam
from .adascale import AdaScale, AdaScaleAutoLR
from .base import FusedSGD, Optimizer, apply_updates, scale_by_schedule
from .decentlam import decentlam
from .lamb import lamb
from .schedules import (constant_schedule, controller_scale, linear_warmup,
                        scale_by_controller, set_controller_scale, step_decay,
                        warmup_linear_scale)
from .sgd import sgd

__all__ = ["FusedSGD", "Optimizer", "apply_updates", "sgd", "adam", "lamb",
           "decentlam", "AdaScale", "AdaScaleAutoLR",
           "constant_schedule", "linear_warmup", "step_decay",
           "warmup_linear_scale", "scale_by_schedule", "scale_by_controller",
           "set_controller_scale", "controller_scale"]
