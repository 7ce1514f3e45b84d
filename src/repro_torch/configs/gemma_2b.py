"""gemma-2b — GeGLU, head_dim=256, MQA [arXiv:2403.08295].

18L d_model=2048 8H (GQA kv=1) d_ff=16384 vocab=256000.
"""
from repro_torch.configs.base import ModelConfig, register

GEMMA_2B = register(ModelConfig(
    name="gemma-2b",
    family="dense",
    num_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    act="gelu",              # GeGLU
    tie_embeddings=True,
    scale_embeddings=True,   # embeddings scaled by sqrt(d_model)
    rope_theta=10000.0,
))
