"""gemma-7b — GeGLU, head_dim=256, 16H MHA-ish (kv=16) [arXiv:2403.08295]."""
from .base import ModelConfig, register

register(ModelConfig(
    name="gemma-7b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,
    head_dim=256,
    d_ff=24_576,
    vocab_size=256_000,
    act="gelu",
    tie_embeddings=True,
    scale_embeddings=True,
    layer_pattern=("attn",),
    source="arXiv:2403.08295",
))
