"""internvl2-1b — InternViT frontend (STUB) + InternLM2 backbone
[arXiv:2404.16821].  input_specs() supplies precomputed patch/text embeddings."""
from .base import ModelConfig, register

register(ModelConfig(
    name="internvl2-1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
    vocab_size=151_655,
    embedding_stub=True,
    layer_pattern=("attn",),
    source="arXiv:2404.16821",
))
