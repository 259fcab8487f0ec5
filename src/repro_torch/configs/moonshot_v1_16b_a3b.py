"""moonshot-v1-16b-a3b [moe]: 48L d=2048 16H (MHA kv=16) expert
d_ff=1408 vocab=163840, MoE 64 experts top-6 (+2 shared, Moonlight /
DeepSeek-style) [hf:moonshotai/Moonlight-16B-A3B]."""

from repro_torch.config.base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe", n_layers=48, d_model=2048,
    n_heads=16, n_kv_heads=16, head_dim=128, d_ff=0, vocab_size=163840,
    moe=True, n_experts=64, top_k=6, moe_d_ff=1408, n_shared_experts=2,
    first_dense_layers=1,
)

SMOKE_CONFIG = ModelConfig(
    name="moonshot-smoke", family="moe", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=4, head_dim=32, d_ff=0, vocab_size=512,
    moe=True, n_experts=8, top_k=2, moe_d_ff=64, n_shared_experts=1,
    first_dense_layers=1, vocab_pad_multiple=128, remat="none",
)
