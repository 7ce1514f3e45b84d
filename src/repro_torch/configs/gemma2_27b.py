"""gemma2-27b — local+global alternating, logit softcaps [arXiv:2408.00118].

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000, head_dim=128,
sliding window 4096 on alternate layers, attn softcap 50, final softcap 30,
query scale (d_model/n_heads)^-0.5 = 144^-0.5, pre+post sublayer norms.
"""
from repro_torch.configs.base import ModelConfig, register

GEMMA2_27B = register(ModelConfig(
    name="gemma2-27b",
    family="dense",
    num_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    act="gelu",                    # GeGLU
    attn_softcap=50.0,
    final_softcap=30.0,
    q_scale=(4608 / 32) ** -0.5,   # query_pre_attn_scalar = 144
    window_pattern=(4096, None),   # local, global alternating
    post_norms=True,
    tie_embeddings=True,
    scale_embeddings=True,
    rope_theta=10000.0,
))
