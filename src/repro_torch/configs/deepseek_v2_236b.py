"""deepseek-v2-236b [moe]: 60L d=5120 128H MLA (kv_lora=512,
q_lora=1536, nope 128 / rope 64 / v 128) expert d_ff=1536 vocab=102400,
MoE 160 routed top-6 + 2 shared, first layer dense [arXiv:2405.04434]."""

from repro_torch.config.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe", n_layers=60, d_model=5120,
    n_heads=128, n_kv_heads=128, d_ff=12288, vocab_size=102400,
    attn_kind="mla", q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    moe=True, n_experts=160, top_k=6, moe_d_ff=1536,
    n_shared_experts=2, first_dense_layers=1,
)

SMOKE_CONFIG = ModelConfig(
    name="deepseek-smoke", family="moe", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=4, d_ff=256, vocab_size=512,
    attn_kind="mla", q_lora_rank=64, kv_lora_rank=32,
    qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32,
    moe=True, n_experts=8, top_k=2, moe_d_ff=64, n_shared_experts=1,
    first_dense_layers=1, vocab_pad_multiple=128, remat="none",
)
