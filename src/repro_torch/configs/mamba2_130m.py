"""mamba2-130m [ssm]: 24L d=768, attention-free, vocab=50280,
ssm_state=128 — SSD (state-space duality) [arXiv:2405.21060]."""

from repro_torch.config.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm", n_layers=24, d_model=768,
    n_heads=12, n_kv_heads=12, d_ff=0, vocab_size=50280,
    attn_kind="none", ssm=True, ssm_state=128, ssm_head_dim=64,
    ssm_expand=2, tie_embeddings=True,
)

SMOKE_CONFIG = ModelConfig(
    name="mamba2-smoke", family="ssm", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=4, d_ff=0, vocab_size=512,
    attn_kind="none", ssm=True, ssm_state=16, ssm_head_dim=32,
    ssm_expand=2, tie_embeddings=True, vocab_pad_multiple=128,
    remat="none", ssm_chunk=16,
)
