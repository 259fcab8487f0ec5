"""Shared neural layers: norms, RoPE, MLPs, embeddings.

The port's copy of ``repro.models.layers``. Parameters are float32
master tensors cast to the activation dtype where the reference casts
them; the norms compute in float32 and cast back, as the reference's do.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(dt) * scale.to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    y = (x - mu) * torch.rsqrt(var + eps)
    return y.to(dt) * scale.to(dt) + bias.to(dt)


def apply_norm(cfg, x: torch.Tensor, p: dict) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layer_norm(x, p["scale"], p["bias"])
    return rms_norm(x, p["scale"])


def norm_params(cfg, dim: int, draw) -> dict:
    p = {"scale": draw.ones((dim,))}
    if cfg.norm == "layernorm":
        p["bias"] = draw.zeros((dim,))
    return p


# ----------------------------------------------------------------------- #
# RoPE
# ----------------------------------------------------------------------- #

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """float32 inverse frequencies, computed in float64 as the reference's
    NumPy does, on ``device`` (no host-to-device copy in the layer loop:
    on the card that copy would wait for every queued kernel)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float64,
                        device=device) / head_dim
    return (1.0 / (theta ** exps)).to(torch.float32)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., T, H, Dh]; positions: [..., T] integer."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)
    angles = positions[..., None].float() * freqs      # [..., T, Dh/2]
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------- #
# MLP
# ----------------------------------------------------------------------- #

def swiglu(x: torch.Tensor, p: dict) -> torch.Tensor:
    """SwiGLU MLP: (silu(x @ w_gate) * (x @ w_up)) @ w_down."""
    g = torch.einsum("...d,df->...f", x, p["w_gate"].to(x.dtype))
    u = torch.einsum("...d,df->...f", x, p["w_up"].to(x.dtype))
    h = F.silu(g) * u
    return torch.einsum("...f,fd->...d", h, p["w_down"].to(x.dtype))


def swiglu_params(draw, d_model: int, d_ff: int) -> dict:
    s_in = 1.0 / np.sqrt(d_model)
    s_out = 1.0 / np.sqrt(d_ff)
    return {
        "w_gate": draw.normal((d_model, d_ff), s_in),
        "w_up": draw.normal((d_model, d_ff), s_in),
        "w_down": draw.normal((d_ff, d_model), s_out),
    }


# ----------------------------------------------------------------------- #
# Embedding / unembedding
# ----------------------------------------------------------------------- #

def embed_params(draw, padded_vocab: int, d_model: int, tie: bool) -> dict:
    p = {"embedding": draw.normal((padded_vocab, d_model), 0.02)}
    if not tie:
        p["unembed"] = draw.normal((padded_vocab, d_model), 0.02)
    return p


def embed(tokens: torch.Tensor, p: dict, dtype) -> torch.Tensor:
    # Gather, then cast: the same values as the reference's cast-then-
    # gather, without converting the whole padded table per call.
    return p["embedding"][tokens].to(dtype)


def unembed(x: torch.Tensor, p: dict) -> torch.Tensor:
    w = p.get("unembed", p["embedding"])
    return torch.einsum("...d,vd->...v", x, w.to(x.dtype))
