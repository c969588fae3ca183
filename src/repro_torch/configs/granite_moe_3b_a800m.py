"""granite-moe-3b-a800m [moe] — hf:ibm-granite/granite-3.0-1b-a400m-base
family per assignment: 40 experts top-8, per-expert d_ff=512."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab=49155,
    n_experts=40,
    experts_per_tok=8,
    moe_every=1,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    param_dtype="bfloat16", compute_dtype="bfloat16",
)
