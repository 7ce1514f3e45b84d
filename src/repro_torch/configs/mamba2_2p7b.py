"""mamba2-2.7b — SSD (state-space duality) [arXiv:2405.21060].

64L d_model=2560 attention-free, vocab=50280, ssm_state=128.
d_inner = 2*2560 = 5120, headdim 64 -> 80 SSD heads, ngroups=1, conv=4.
"""
from repro_torch.configs.base import ModelConfig, register

MAMBA2_2P7B = register(ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_ngroups=1,
    ssm_conv=4,
    ssm_chunk=256,
    tie_embeddings=True,
))
