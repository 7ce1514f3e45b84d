"""musicgen-large — decoder-only over EnCodec tokens [arXiv:2306.05284].

48L d_model=2048 32H (kv=32, MHA) d_ff=8192 vocab=2048 (per codebook),
4 codebooks with the delay interleaving handled by the (stubbed) frontend;
the backbone sums codebook embeddings and emits 4 LM heads.
"""
from repro_torch.configs.base import ModelConfig, register

MUSICGEN_LARGE = register(ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    vocab_pad_to=128,
    act="gelu_plain",       # ungated MLP
    frontend="audio",
    n_codebooks=4,
    rope_theta=10000.0,
))
