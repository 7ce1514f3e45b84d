"""llama2-70b — the paper's own Figure-1 reference model (via Splitwise).

Not one of the 10 assigned archs; used by benchmarks/endurance_fig1.py to
reproduce the paper's KV-cache endurance-requirement computation.
80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=32000.
"""
from repro_torch.configs.base import ModelConfig, register

LLAMA2_70B = register(ModelConfig(
    name="llama2-70b",
    family="dense",
    num_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=32000,
    act="silu",
    rope_theta=10000.0,
))
