"""llava-next-mistral-7b [vlm]: Mistral-7B backbone, 32L d=4096 32H
(GQA kv=8, head_dim=128) d_ff=14336 vocab=32000 — anyres tiling gives
2880 patch tokens (5 tiles x 576); the vision tower is a STUB
(input_specs provides precomputed patch embeddings)
[hf:llava-hf/llava-v1.6-mistral-7b-hf]."""

from repro_torch.config.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="vlm", n_layers=32,
    d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128, d_ff=14336,
    vocab_size=32000, rope_theta=1e6, frontend="vision",
    n_frontend_tokens=2880,
)

SMOKE_CONFIG = ModelConfig(
    name="llava-smoke", family="vlm", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512,
    frontend="vision", n_frontend_tokens=16, vocab_pad_multiple=128,
    remat="none",
)
