"""qwen1.5-0.5b [dense]: 24L d=1024 16H (MHA kv=16) d_ff=2816
vocab=151936 — QKV bias [hf:Qwen/Qwen1.5-0.5B]."""

from repro_torch.config.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b", family="dense", n_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=16, head_dim=64, d_ff=2816,
    vocab_size=151936, qkv_bias=True, rope_theta=1e6,
)

SMOKE_CONFIG = ModelConfig(
    name="qwen1.5-smoke", family="dense", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=4, head_dim=32, d_ff=256, vocab_size=512,
    qkv_bias=True, vocab_pad_multiple=128, remat="none",
)
