"""Config registry of the port: the architectures ported so far — the
dense family (transformer-100m and the four dense configs of the
reference, which the ``use_pallas`` flash-attention route runs), the moe
family (granite-moe-3b-a800m, qwen3-moe-235b-a22b) and the hybrid family
(jamba-v0.1-52b)."""
from .base import ModelConfig
from .gemma2_27b import CONFIG as GEMMA2_27B
from .granite_20b import CONFIG as GRANITE_20B
from .granite_moe_3b_a800m import CONFIG as GRANITE_MOE_3B
from .jamba_v01_52b import CONFIG as JAMBA_52B
from .mistral_large_123b import CONFIG as MISTRAL_LARGE_123B
from .qwen3_moe_235b_a22b import CONFIG as QWEN3_MOE_235B
from .transformer_100m import CONFIG as TRANSFORMER_100M
from .yi_34b import CONFIG as YI_34B

REGISTRY = {c.name: c for c in [MISTRAL_LARGE_123B, GEMMA2_27B, GRANITE_20B,
                                 YI_34B, TRANSFORMER_100M, GRANITE_MOE_3B,
                                 QWEN3_MOE_235B, JAMBA_52B]}


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise NotImplementedError(
            f"arch '{name}' is not ported yet (ported: {sorted(REGISTRY)}); "
            "the ssm, vlm and audio families arrive with ROADMAP slice 5b "
            "of the model zoo")
    return REGISTRY[name]


__all__ = ["ModelConfig", "REGISTRY", "get_config"]
