"""The port's models (see ``model.build_model``)."""
from .model import ModelAPI, build_model, make_synthetic_batch

__all__ = ["ModelAPI", "build_model", "make_synthetic_batch"]
