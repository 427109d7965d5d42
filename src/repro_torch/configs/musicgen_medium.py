"""musicgen-medium — decoder-only over EnCodec tokens [arXiv:2306.05284].
EnCodec frontend is a STUB: input_specs() supplies precomputed frame
embeddings; the backbone predicts codebook tokens (vocab=2048)."""
from .base import ModelConfig, register

register(ModelConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    embedding_stub=True,
    act="gelu",
    gated_mlp=False,
    layer_pattern=("attn",),
    source="arXiv:2306.05284",
))
