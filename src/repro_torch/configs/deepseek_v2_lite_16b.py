"""deepseek-v2-lite-16b — MLA + fine-grained MoE [arXiv:2405.04434].

27L d_model=2048 16H, MLA kv_lora=512 (qk_nope 128, qk_rope 64, v 128,
no q-LoRA on Lite), MoE 64 routed top-6 + 2 shared, expert d_ff=1408,
first layer dense (d_ff=10944), vocab=102400.

NOTE (DESIGN.md §5): the assignment line says both "MoE 64e top-6" and
"2 shared+160 routed"; 160 is the V2-big count. We follow 64 routed
(the V2-Lite figure, consistent with "64e top-6").
"""
from repro_torch.configs.base import ModelConfig, register

DEEPSEEK_V2_LITE = register(ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,             # the single leading dense layer
    vocab_size=102400,
    act="silu",
    kv_lora_rank=512,
    q_lora_rank=0,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    n_experts=64,
    n_shared_experts=2,
    moe_top_k=6,
    expert_d_ff=1408,
    first_dense_layers=1,
    rope_theta=10000.0,
))
