"""The port's optimizers (stacked, learner-leading states; see ``base``).

Ported so far: ``sgd`` (the paper's optimizer, with its fused recipe) and
the schedule/controller wrappers.  ``adam``, ``lamb``, ``decentlam`` and
``adascale`` come later (ROADMAP Queue A item 10).
"""
from .base import FusedSGD, Optimizer, apply_updates, scale_by_schedule
from .schedules import (constant_schedule, controller_scale, linear_warmup,
                        scale_by_controller, set_controller_scale, step_decay,
                        warmup_linear_scale)
from .sgd import sgd

__all__ = ["FusedSGD", "Optimizer", "apply_updates", "sgd",
           "constant_schedule", "linear_warmup", "step_decay",
           "warmup_linear_scale", "scale_by_schedule", "scale_by_controller",
           "set_controller_scale", "controller_scale"]
