"""granite-34b — llama-arch code model, MQA (GQA kv=1) [arXiv:2405.04324]."""
from .base import ModelConfig, register

register(ModelConfig(
    name="granite-34b",
    family="dense",
    num_layers=88,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    d_ff=24_576,
    vocab_size=49_152,
    act="gelu",
    gated_mlp=False,
    layer_pattern=("attn",),
    source="arXiv:2405.04324",
))
