"""mamba2-130m — SSD (state-space duality), attention-free [arXiv:2405.21060]."""
from .base import ModelConfig, SSMConfig, register

register(ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50_280,
    layer_pattern=("ssm",),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
    tie_embeddings=True,
    source="arXiv:2405.21060",
))
