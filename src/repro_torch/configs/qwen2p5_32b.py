"""qwen2.5-32b [dense]: 64L d=5120 40H (GQA kv=8, head_dim=128)
d_ff=27648 vocab=152064 — GQA, QKV bias [hf:Qwen/Qwen2.5 family]."""

from repro_torch.config.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b", family="dense", n_layers=64, d_model=5120,
    n_heads=40, n_kv_heads=8, head_dim=128, d_ff=27648,
    vocab_size=152064, qkv_bias=True, rope_theta=1e6,
)

SMOKE_CONFIG = ModelConfig(
    name="qwen2.5-smoke", family="dense", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512,
    qkv_bias=True, vocab_pad_multiple=128, remat="none",
)
