"""gemma3-27b — 5:1 local:global sliding-window pattern, 128k context
[hf:google/gemma-3 family].  62 layers = 10 x (5 local + 1 global) + 2 local
tail (handled as unscanned remainder layers)."""
from .base import ModelConfig, register

register(ModelConfig(
    name="gemma3-27b",
    family="dense",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=21_504,
    vocab_size=262_144,
    act="gelu",
    qk_norm=True,
    tie_embeddings=True,
    scale_embeddings=True,
    sliding_window=1024,
    rope_theta=1_000_000.0,
    layer_pattern=("local", "local", "local", "local", "local", "global"),
    tail_pattern=("local", "local"),
    source="hf:google/gemma-3-1b-pt (scaled)",
))
