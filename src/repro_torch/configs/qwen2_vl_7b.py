"""qwen2-vl-7b [vlm] — arXiv:2409.12191.  M-RoPE (t/h/w sections); the
ViT vision tower is a stub per the assignment carve-out — input_specs
provides patch embeddings."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab=152064,
    mrope_sections=(16, 24, 24),   # halves of head_dim 128
    rope_theta=1e6,
    n_frontend_tokens=1024,
    modality="vision",
    source="arXiv:2409.12191",
    param_dtype="bfloat16", compute_dtype="bfloat16",
)
