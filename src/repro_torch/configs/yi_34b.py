"""yi-34b [dense] — arXiv:2403.04652.  Llama-arch GQA.  The reference's
``repro/configs/yi_34b.py``, field for field."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab=64000,
    rope_theta=5e6,
    source="arXiv:2403.04652",
    param_dtype="bfloat16", compute_dtype="bfloat16",
)
