"""seamless-m4t-large-v2 [audio] — arXiv:2308.11596.  Enc-dec transformer
backbone; the speech frontend (mel + conformer feature extractor) is a stub
per the assignment carve-out: input_specs provides frame embeddings."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,            # decoder layers
    enc_layers=24,          # encoder layers (model card: 24/24)
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab=256206,
    modality="audio",
    source="arXiv:2308.11596",
    param_dtype="bfloat16", compute_dtype="bfloat16",
)
