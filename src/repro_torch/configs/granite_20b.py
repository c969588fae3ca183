"""granite-20b [dense] — arXiv:2405.04324.  Llama-arch code model; MQA
(single KV head).  The reference's ``repro/configs/granite_20b.py``,
field for field."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab=49152,
    source="arXiv:2405.04324",
    param_dtype="bfloat16", compute_dtype="bfloat16",
)
