"""mistral-large-123b [dense] — hf:mistralai/Mistral-Large-Instruct-2407.
The reference's ``repro/configs/mistral_large_123b.py``, field for
field."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    n_layers=88,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab=32768,
    rope_theta=1e6,
    attn_pattern="global",
    window=4096,
    source="hf:mistralai/Mistral-Large-Instruct-2407",
    param_dtype="bfloat16", compute_dtype="bfloat16",
)
