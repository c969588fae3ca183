"""gemma2-27b [dense] — arXiv:2408.00118.  Local/global alternating
attention, attn + final logit soft-capping.  The reference's
``repro/configs/gemma2_27b.py``, field for field."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab=256000,
    attn_pattern="local_global",
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    tie_embeddings=True,
    source="arXiv:2408.00118",
    param_dtype="bfloat16", compute_dtype="bfloat16",
)
