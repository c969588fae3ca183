"""xlstm-350m [ssm] — arXiv:2405.04517.  Alternating mLSTM / sLSTM blocks
(d_ff=0: the blocks carry their own projections)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    head_dim=256,
    d_ff=0,
    vocab=50304,
    block_period=("mlstm", "slstm"),
    scan_chunk=64,
    use_rope=False,
    source="arXiv:2405.04517",
    param_dtype="bfloat16", compute_dtype="bfloat16",
)
