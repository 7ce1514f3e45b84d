"""qwen3-8b — qk_norm, GQA [hf:Qwen/Qwen3-8B].

36L d_model=4096 32H (GQA kv=8) d_ff=12288 vocab=151936, head_dim=128.
"""
from repro_torch.configs.base import ModelConfig, register

QWEN3_8B = register(ModelConfig(
    name="qwen3-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=12288,
    vocab_size=151936,
    act="silu",
    qk_norm=True,
    rope_theta=1_000_000.0,
))
