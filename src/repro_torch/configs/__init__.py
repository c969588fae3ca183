"""Config registry of the port: every architecture of the reference — the
dense family (transformer-100m and the four dense configs, which the
``use_pallas`` flash-attention route runs), the moe family
(granite-moe-3b-a800m, qwen3-moe-235b-a22b), the hybrid family
(jamba-v0.1-52b), the ssm family (xlstm-350m), the vlm family
(qwen2-vl-7b) and the audio family (seamless-m4t-large-v2); the dry
run's ``ASSIGNED`` architectures and input ``SHAPES``."""
from .base import ModelConfig
from .gemma2_27b import CONFIG as GEMMA2_27B
from .granite_20b import CONFIG as GRANITE_20B
from .granite_moe_3b_a800m import CONFIG as GRANITE_MOE_3B
from .jamba_v01_52b import CONFIG as JAMBA_52B
from .mistral_large_123b import CONFIG as MISTRAL_LARGE_123B
from .qwen2_vl_7b import CONFIG as QWEN2_VL_7B
from .qwen3_moe_235b_a22b import CONFIG as QWEN3_MOE_235B
from .seamless_m4t_large_v2 import CONFIG as SEAMLESS_M4T
from .transformer_100m import CONFIG as TRANSFORMER_100M
from .xlstm_350m import CONFIG as XLSTM_350M
from .yi_34b import CONFIG as YI_34B

REGISTRY = {c.name: c for c in [MISTRAL_LARGE_123B, GEMMA2_27B, GRANITE_20B,
                                 YI_34B, TRANSFORMER_100M, GRANITE_MOE_3B,
                                 QWEN3_MOE_235B, JAMBA_52B, XLSTM_350M,
                                 QWEN2_VL_7B, SEAMLESS_M4T]}

# the architectures the dry run sweeps, in the reference's order (every
# config but transformer-100m, the paper-scale example)
ASSIGNED = [c.name for c in [
    MISTRAL_LARGE_123B, SEAMLESS_M4T, GEMMA2_27B, GRANITE_20B,
    QWEN3_MOE_235B, XLSTM_350M, YI_34B, GRANITE_MOE_3B, QWEN2_VL_7B,
    JAMBA_52B,
]]

# assigned input shapes: (seq_len, global_batch, kind)
SHAPES = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch '{name}'; available: "
                       f"{sorted(REGISTRY)}")
    return REGISTRY[name]


__all__ = ["ModelConfig", "REGISTRY", "ASSIGNED", "SHAPES", "get_config"]
