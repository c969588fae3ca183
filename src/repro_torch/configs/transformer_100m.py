"""~100M-param dense LM: 12L, d=768, 12H, head_dim 64, d_ff 2048, vocab
32768 — llama-style (RMSNorm + RoPE + SwiGLU).  The reference's
``repro/configs/transformer_100m.py``, field for field."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="transformer-100m",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=2048,
    vocab=32768,
    attn_chunk=256,
    source="paper-scale example (deliverable b)",
)
