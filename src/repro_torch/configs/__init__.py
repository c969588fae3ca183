"""Config registry of the port: the architectures ported so far."""
from .base import ModelConfig
from .transformer_100m import CONFIG as TRANSFORMER_100M

REGISTRY = {c.name: c for c in [TRANSFORMER_100M]}


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise NotImplementedError(
            f"arch '{name}' is not ported yet (ported: {sorted(REGISTRY)}); "
            "the other architectures arrive with ROADMAP slice 5, the model "
            "zoo")
    return REGISTRY[name]


__all__ = ["ModelConfig", "REGISTRY", "get_config"]
