"""zamba2-1.2b — Mamba2 backbone + shared attention block [arXiv:2411.15242].
38 layers = 6 x (5 ssm + 1 shared_attn) + 2 ssm tail; the shared_attn block
reuses one global set of attention+MLP weights at every application."""
from .base import ModelConfig, SSMConfig, register

register(ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32_000,
    layer_pattern=("ssm", "ssm", "ssm", "ssm", "ssm", "shared_attn"),
    tail_pattern=("ssm", "ssm"),
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=256),
    shared_attention=True,
    source="arXiv:2411.15242",
))
