"""deepseek-7b — llama-arch dense [arXiv:2401.02954].

30L d_model=4096 32H (GQA kv=32, i.e. MHA) d_ff=11008 vocab=102400.
"""
from repro_torch.configs.base import ModelConfig, register

DEEPSEEK_7B = register(ModelConfig(
    name="deepseek-7b",
    family="dense",
    num_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,
    d_ff=11008,
    vocab_size=102400,
    act="silu",
    rope_theta=10000.0,
))
