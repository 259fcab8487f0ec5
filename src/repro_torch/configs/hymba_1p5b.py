"""hymba-1.5b [hybrid]: 32L d=1600 25H (GQA kv=5) d_ff=5504 vocab=32001,
ssm_state=16 — parallel attention+mamba heads per layer, SWA with 3
global full-attention layers (first/middle/last) [arXiv:2411.13676]."""

from repro_torch.config.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid", n_layers=32, d_model=1600,
    n_heads=25, n_kv_heads=5, head_dim=64, d_ff=5504, vocab_size=32001,
    attn_kind="gqa", sliding_window=1024,
    global_attn_layers=(0, 15, 31),
    ssm=True, ssm_state=16, ssm_head_dim=64, ssm_expand=2,
    hybrid_parallel=True,
)

SMOKE_CONFIG = ModelConfig(
    name="hymba-smoke", family="hybrid", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512,
    attn_kind="gqa", sliding_window=32, global_attn_layers=(0,),
    ssm=True, ssm_state=16, ssm_head_dim=32, ssm_expand=2,
    hybrid_parallel=True, vocab_pad_multiple=128, remat="none",
    ssm_chunk=16,
)
