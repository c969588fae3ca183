"""Crash-safe checkpoints of trees of tensors — the port of
``repro/checkpoint``."""
from .checkpoint import (latest_step, restore_checkpoint, save_checkpoint,
                         verify_checkpoint)

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "verify_checkpoint"]
