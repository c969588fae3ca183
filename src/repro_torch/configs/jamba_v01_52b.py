"""jamba-v0.1-52b [hybrid] — arXiv:2403.19887.  Period of 8 layers:
attention at offset 4, mamba elsewhere; MoE (16 experts top-2) every 2nd
layer.  No RoPE (mamba carries position)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=65536,
    n_experts=16,
    experts_per_tok=2,
    moe_every=2,
    block_period=8 * ("mamba",),
    attn_layer_offset=4,
    ssm_state=16, ssm_conv=4, ssm_expand=2,
    use_rope=False,
    attn_pattern="sliding",        # jamba attn layers; window for long ctx
    window=4096,
    source="arXiv:2403.19887",
    param_dtype="bfloat16", compute_dtype="bfloat16",
)
