"""mixtral-8x22b — 8 experts top-2, SWA [arXiv:2401.04088].

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768, MoE 8e top-2,
sliding window 4096 (per assignment), head_dim=128.
"""
from repro_torch.configs.base import ModelConfig, register

MIXTRAL_8X22B = register(ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,            # == expert_d_ff; every MLP is MoE
    vocab_size=32768,
    act="silu",
    n_experts=8,
    moe_top_k=2,
    expert_d_ff=16384,
    window_pattern=(4096,),
    rope_theta=1_000_000.0,
))
