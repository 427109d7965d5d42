"""olmoe-1b-7b — 64-expert top-8 MoE [arXiv:2409.02060]."""
from .base import ModelConfig, MoEConfig, register

register(ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1024,
    vocab_size=50_304,
    qk_norm=True,
    layer_pattern=("moe",),
    moe=MoEConfig(num_experts=64, top_k=8, d_ff_expert=1024),
    source="arXiv:2409.02060",
))
