"""internvl2-76b — InternViT + (Llama3-70B-class) backbone [arXiv:2404.16821].

Backbone only per the assignment: 80L d_model=8192 64H (GQA kv=8)
d_ff=28672 vocab=128256. The InternViT frontend is a STUB — input_specs()
provides precomputed patch embeddings (256 tokens) prepended to the text.
"""
from repro_torch.configs.base import ModelConfig, register

INTERNVL2_76B = register(ModelConfig(
    name="internvl2-76b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    act="silu",
    frontend="vision",
    n_frontend_tokens=256,
    rope_theta=500000.0,
))
