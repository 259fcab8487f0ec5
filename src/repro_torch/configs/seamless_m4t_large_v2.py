"""seamless-m4t-large-v2 [audio]: 24L enc + 24L dec, d=1024 16H (MHA)
d_ff=8192 vocab=256206 — encoder-decoder; the audio frontend is a STUB
(input_specs provides precomputed frame embeddings) [arXiv:2308.11596].

Shape interpretation (DESIGN.md): train_4k = 2048 source frames + 2048
target tokens; decode shapes run the DECODER against a fixed 4096-frame
encoder memory."""

from repro_torch.config.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="audio", n_layers=24,
    d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64, d_ff=8192,
    vocab_size=256206, encoder_decoder=True, n_encoder_layers=24,
    frontend="audio", n_frontend_tokens=4096,
)

SMOKE_CONFIG = ModelConfig(
    name="seamless-smoke", family="audio", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=4, head_dim=32, d_ff=256, vocab_size=512,
    encoder_decoder=True, n_encoder_layers=2, frontend="audio",
    n_frontend_tokens=32, vocab_pad_multiple=128, remat="none",
)
