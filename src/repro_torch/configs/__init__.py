"""Config registry of the port: the architectures ported so far — the
dense family (transformer-100m and the four dense configs of the
reference, which the ``use_pallas`` flash-attention route runs)."""
from .base import ModelConfig
from .gemma2_27b import CONFIG as GEMMA2_27B
from .granite_20b import CONFIG as GRANITE_20B
from .mistral_large_123b import CONFIG as MISTRAL_LARGE_123B
from .transformer_100m import CONFIG as TRANSFORMER_100M
from .yi_34b import CONFIG as YI_34B

REGISTRY = {c.name: c for c in [MISTRAL_LARGE_123B, GEMMA2_27B, GRANITE_20B,
                                 YI_34B, TRANSFORMER_100M]}


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise NotImplementedError(
            f"arch '{name}' is not ported yet (ported: {sorted(REGISTRY)}); "
            "the moe, ssm, hybrid, vlm and audio families arrive with "
            "ROADMAP slice 5, the model zoo")
    return REGISTRY[name]


__all__ = ["ModelConfig", "REGISTRY", "get_config"]
