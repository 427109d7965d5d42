"""qwen3-14b — qk_norm, GQA kv=8 [hf:Qwen/Qwen3-8B family]."""
from .base import ModelConfig, register

register(ModelConfig(
    name="qwen3-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=17_408,
    vocab_size=151_936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    layer_pattern=("attn",),
    source="hf:Qwen/Qwen3-8B",
))
