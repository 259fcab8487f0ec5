"""The frozen yardstick: floating-point operations that a cell's inputs
need, and the card's published peak.

Counted as the work requires, whatever the program does: 2 operations a
multiply-add; every weight matrix of every layer once a token (biases and
norms left out); causal attention at its half (scores and the weighted
sum, ``T * T / 2`` query-key pairs a head); the LM head over the real
vocabulary and only for the positions whose logits are used; a training
step 3 times its forward pass (no recomputation); a decoded token's
attention over the positions it sees."""

from __future__ import annotations

# One NVIDIA H100 SXM, dense bfloat16 on the tensor cores (data sheet).
PEAK_BF16_FLOPS = 989.4e12


def layer_weights(a: dict) -> int:
    """Multiply-adds a token makes with one layer's weight matrices."""
    d, h, kv, dh, f = a["d"], a["heads"], a["kv_heads"], a["head_dim"], a["d_ff"]
    return d * (h + 2 * kv) * dh + h * dh * d + 3 * d * f


def non_embedding(a: dict) -> int:
    return a["layers"] * layer_weights(a)


def lm_head(a: dict) -> int:
    return a["d"] * a["vocab"]


def causal_attention(a: dict, t: int) -> float:
    """One sequence of ``t`` tokens through every layer's attention core,
    forward: QK^T and PV over ``t * t / 2`` pairs a head."""
    return a["layers"] * 2 * 2 * (t * t / 2) * a["heads"] * a["head_dim"]


def forward(a: dict, t: int, head_tokens: int) -> float:
    """A forward pass over one sequence of ``t`` tokens, with the LM head
    at ``head_tokens`` positions."""
    return (2 * non_embedding(a) * t + causal_attention(a, t)
            + 2 * lm_head(a) * head_tokens)


def train_step(a: dict, seqs: int, t: int) -> float:
    """Forward and backward over ``seqs`` rows of ``t`` tokens."""
    return 3 * seqs * forward(a, t, t)


def prefill(a: dict, t: int) -> float:
    """A prompt of ``t`` tokens, logits at its last position."""
    return forward(a, t, 1)


def decode_token(a: dict, context: int) -> float:
    """One decoded token that attends to ``context`` positions (itself
    included)."""
    attn = a["layers"] * 2 * 2 * context * a["heads"] * a["head_dim"]
    return 2 * non_embedding(a) + attn + 2 * lm_head(a)
