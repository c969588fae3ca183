"""The port's models (dense decoder for serving; see ``model.build_model``)."""
from .model import ModelAPI, build_model

__all__ = ["ModelAPI", "build_model"]
