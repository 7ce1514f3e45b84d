"""hymba-1.5b — parallel attn+mamba heads [arXiv:2411.13676].

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16,
128 meta tokens, SWA 2048 everywhere except global layers {0, 15, 31}.
Cross-layer KV sharing is NOT modelled (DESIGN.md §5).
"""
from repro_torch.configs.base import ModelConfig, register

HYMBA_1P5B = register(ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    act="silu",
    ssm_state=16,
    ssm_expand=2,
    ssm_headdim=64,       # d_inner = 3200 -> 50 SSD heads
    ssm_ngroups=1,
    window_pattern=(2048,),
    global_layers=(0, 15, 31),
    n_meta_tokens=128,
    rope_theta=10000.0,
))
