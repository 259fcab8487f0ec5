"""Config system: model / training configs + arch registry.

The port's copy of ``repro.config.base``: the same dataclasses, shape
cells and arch registry, field for field. ``param_count`` counts the
port's parameter tree (``repro_torch.models.model.count_params``), which
has the reference's shapes."""

from __future__ import annotations

import dataclasses
import importlib


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense|moe|ssm|hybrid|audio|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    # --- attention ---
    attn_kind: str = "gqa"           # gqa | mla | none
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    sliding_window: int = 0          # 0 -> full attention
    global_attn_layers: tuple[int, ...] = ()   # full-attn layers under SWA
    # --- MLA (deepseek-v2) ---
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    # --- MoE ---
    moe: bool = False
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0      # leading dense layers (deepseek-style)
    capacity_factor: float = 1.25
    # --- SSM (mamba2 / hybrid) ---
    ssm: bool = False
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    hybrid_parallel: bool = False    # Hymba: parallel attn + ssm heads
    # --- encoder-decoder ---
    encoder_decoder: bool = False
    n_encoder_layers: int = 0
    # --- modality frontend stubs ---
    frontend: str = "none"           # none | audio | vision
    n_frontend_tokens: int = 0       # e.g. 2880 anyres patch tokens (llava)
    # --- misc ---
    norm: str = "rmsnorm"
    act: str = "silu"
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: str = "full"              # none | full
    vocab_pad_multiple: int = 2048
    # Small-model serving: replicated weights + sequence-parallel
    # activations on the model axis (set by launch/steps.py; §Perf H1.2).
    serve_seq_parallel: bool = False
    # MLA decode: absorbed-matrix form (True) vs per-step decompression
    # (False — the naive baseline; §Perf H3).
    mla_absorbed_decode: bool = True

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return (self.vocab_size + m - 1) // m * m

    @property
    def attn_free(self) -> bool:
        return self.attn_kind == "none"

    def param_count(self) -> int:
        """Total parameters (exact to the construction in model.py)."""
        from repro_torch.models.model import count_params  # no cycle
        return count_params(self)

    def active_param_count(self) -> int:
        from repro_torch.models.model import count_params
        return count_params(self, active_only=True)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell of the assigned grid."""
    name: str                        # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                        # train | prefill | decode
    seq_len: int
    global_batch: int


LM_SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    warmup_steps: int = 100
    total_steps: int = 10000
    grad_clip: float = 1.0
    z_loss: float = 1e-4
    moe_aux_loss: float = 1e-2
    microbatches: int = 1            # gradient accumulation
    grad_compression: bool = False   # int8 + error feedback on DP all-reduce
    checkpoint_every: int = 100
    seed: int = 0


ARCH_IDS = (
    "hymba-1.5b", "qwen1.5-0.5b", "qwen3-1.7b", "qwen2.5-32b",
    "phi3-medium-14b", "seamless-m4t-large-v2", "llava-next-mistral-7b",
    "moonshot-v1-16b-a3b", "deepseek-v2-236b", "mamba2-130m",
)

_MODULES = {
    "hymba-1.5b": "hymba_1p5b",
    "qwen1.5-0.5b": "qwen1p5_0p5b",
    "qwen3-1.7b": "qwen3_1p7b",
    "qwen2.5-32b": "qwen2p5_32b",
    "phi3-medium-14b": "phi3_medium_14b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "mamba2-130m": "mamba2_130m",
}


def get_config(arch: str) -> ModelConfig:
    """``--arch <id>`` entry point."""
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.SMOKE_CONFIG


def shapes_for(arch: str) -> dict[str, ShapeConfig]:
    """The shape cells assigned to an arch, with documented skips."""
    cfg = get_config(arch)
    shapes = dict(LM_SHAPES)
    # long_500k only for sub-quadratic archs (SSM/hybrid) — see DESIGN.md.
    if cfg.family not in ("ssm", "hybrid"):
        shapes.pop("long_500k")
    return shapes
