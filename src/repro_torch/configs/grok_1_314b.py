"""grok-1-314b — 8-expert top-2 MoE, 314B total params [hf:xai-org/grok-1]."""
from .base import ModelConfig, MoEConfig, register

register(ModelConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=32_768,
    vocab_size=131_072,
    layer_pattern=("moe",),
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=32_768),
    source="hf:xai-org/grok-1",
))
