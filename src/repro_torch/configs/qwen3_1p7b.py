"""qwen3-1.7b [dense]: 28L d=2048 16H (GQA kv=8, head_dim=128)
d_ff=6144 vocab=151936 — qk_norm [hf:Qwen/Qwen3 family]."""

from repro_torch.config.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b", family="dense", n_layers=28, d_model=2048,
    n_heads=16, n_kv_heads=8, head_dim=128, d_ff=6144,
    vocab_size=151936, qk_norm=True, rope_theta=1e6,
)

SMOKE_CONFIG = ModelConfig(
    name="qwen3-smoke", family="dense", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512,
    qk_norm=True, vocab_pad_multiple=128, remat="none",
)
