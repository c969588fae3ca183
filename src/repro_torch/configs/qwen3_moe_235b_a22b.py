"""qwen3-moe-235b-a22b [moe] — hf:Qwen/Qwen3-30B-A3B family scaled per
assignment: 128 experts, top-8, per-expert d_ff=1536."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab=151936,
    n_experts=128,
    experts_per_tok=8,
    moe_every=1,
    rope_theta=1e6,
    source="hf:Qwen/Qwen3-30B-A3B",
    param_dtype="bfloat16", compute_dtype="bfloat16",
)
