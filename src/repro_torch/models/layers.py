"""Shared neural layers: norms, RoPE, MLPs, embeddings.

The port's copy of ``repro.models.layers``. Parameters are float32
master tensors cast to the activation dtype where the reference casts
them; the norms compute in float32 and cast back, as the reference's do.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.distributed.constraints import is_dtensor


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
# Token-wise maps
# ----------------------------------------------------------------------- #

def contiguous_stride(shape) -> tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape``."""
    stride, n = [], 1
    for d in reversed(tuple(shape)):
        stride.append(n)
        n *= int(d)
    return tuple(reversed(stride))


def _letters(sub: str, ndim: int) -> list[str]:
    """One einsum letter per dim (``.`` for the dims of a leading
    ``...``)."""
    if sub.startswith("..."):
        return ["."] * (ndim - len(sub) + 3) + list(sub[3:])
    return list(sub)


def _on_token_shards(eq: str, x, w, n_tok: int):
    """``einsum(eq, x, w)`` on each rank's token shard of ``x`` against the
    whole weight; the output laid out as ``x``'s token dims."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(w, DTensor):
        w = w.redistribute(w.device_mesh,
                           [Replicate()] * w.device_mesh.ndim).to_local()
    y = torch.einsum(eq, x.to_local(), w).contiguous()
    shape = tuple(x.shape[:n_tok]) + tuple(y.shape[n_tok:])
    return DTensor.from_local(y, x.device_mesh, x.placements,
                              shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def token_einsum(eq: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, x, w)`` for a map applied token by token: ``x``'s
    leading dims are tokens that pass to the output, the rest meet the
    weight ``w``. On DTensors, two layouts take their own path:

    * ``x`` sharded on two token dims at once (batch and sequence, under
      sequence-parallel serving) is mapped shard by shard against the
      whole weight: torch 2.11's DTensor cannot merge two sharded dims
      into the one row dim of a matmul (where a gradient is wanted, the
      inner token shard is gathered instead);
    * a contraction over a sharded dim leaves partial sums on the ranks;
      in bfloat16 they are computed and summed across ranks in float32
      and rounded once, as the unsharded matmul accumulates (summing
      bfloat16 partials rounds each layer's output twice more)."""
    if not is_dtensor(x):
        return torch.einsum(eq, x, w)
    from torch.distributed.tensor import DTensor, Replicate
    xs, ws, out = eq.replace("->", ",").split(",")
    n_tok = (x.ndim - 1 if xs.startswith("...")
             else len(os.path.commonprefix([xs, out])))
    dims = sorted({pl.dim for pl in x.placements if pl.is_shard()})
    if len(dims) > 1 and dims[-1] < n_tok and not any(
            pl.is_partial() for pl in x.placements):
        if not (torch.is_grad_enabled()
                and (x.requires_grad or w.requires_grad)):
            return _on_token_shards(eq, x, w, n_tok)
        x = x.redistribute(x.device_mesh, [
            Replicate() if pl.is_shard() and pl.dim > dims[0] else pl
            for pl in x.placements])
    xl, wl = _letters(xs, x.ndim), _letters(ws, w.ndim)
    sharded = {xl[pl.dim] for pl in x.placements if pl.is_shard()}
    if isinstance(w, DTensor):
        sharded |= {wl[pl.dim] for pl in w.placements if pl.is_shard()}
    if (x.dtype in (torch.bfloat16, torch.float16)
            and sharded & (set(xl) & set(wl) - set(out) - {"."})):
        y = torch.einsum(eq, x.float(), w.float())
        y = y.redistribute(y.device_mesh, [
            Replicate() if pl.is_partial() else pl for pl in y.placements])
        return y.to(x.dtype)
    return torch.einsum(eq, x, w)


# ----------------------------------------------------------------------- #
# MLP
# ----------------------------------------------------------------------- #

def swiglu(x: torch.Tensor, p: dict) -> torch.Tensor:
    """SwiGLU MLP: (silu(x @ w_gate) * (x @ w_up)) @ w_down."""
    g = token_einsum("...d,df->...f", x, p["w_gate"].to(x.dtype))
    u = token_einsum("...d,df->...f", x, p["w_up"].to(x.dtype))
    h = F.silu(g) * u
    return token_einsum("...f,fd->...d", h, p["w_down"].to(x.dtype))


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


class _SumOverRanks(torch.autograd.Function):
    """Forward: the sum of ``x`` over the mesh dims ``dims`` (an
    all-reduce on each). Backward: the identity, as each rank's ``x``
    enters the sum once and the sum is used alike on every rank."""

    @staticmethod
    def forward(ctx, x, mesh, dims):
        import torch.distributed._functional_collectives as funcol
        for i in dims:
            x = funcol.wait_tensor(funcol.all_reduce(x, "sum", (mesh, i)))
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def _embed_on_shards(tokens, table):
    """``table[tokens]`` for a DTensor ``table``, looked up on each rank's
    own rows and columns of it: the token ids are gathered whole (they are
    small), each rank gathers the rows it holds (zeros for the others),
    the rows are summed over the mesh dims that split the vocab, and the
    result is laid out as the tokens were (batch shards stay shards).
    DTensor's own rules for indexing or embedding from a sharded table
    and their backward do not hold in every torch version this runs on;
    here every rank's table gradient is its own shard's, as the table's
    layout says."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.distributed.sharding import shard_box
    mesh = table.device_mesh
    whole = [Replicate()] * mesh.ndim
    if isinstance(tokens, DTensor):
        keep = tokens.placements
        ids = tokens.redistribute(mesh, whole).to_local()
    else:
        keep, ids = whole, tokens
    v0, nv = shard_box(table)[0]
    hit = (ids >= v0) & (ids < v0 + nv)
    local = F.embedding((ids - v0).clamp(0, nv - 1), table.to_local())
    local = local * hit[..., None].to(local.dtype)
    local = _SumOverRanks.apply(
        local, mesh, [i for i, pl in enumerate(table.placements)
                      if pl.is_shard(0)])
    pl = [Shard(ids.ndim) if tp.is_shard(1) else Replicate()
          for tp in table.placements]
    shape = tuple(ids.shape) + (table.shape[1],)
    out = DTensor.from_local(local.contiguous(), mesh, pl,
                             shape=torch.Size(shape),
                             stride=contiguous_stride(shape))
    return out.redistribute(mesh, [kp if kp.is_shard() else op
                                   for kp, op in zip(keep, pl)])


def embed(tokens: torch.Tensor, p: dict, dtype) -> torch.Tensor:
    # Gather, then cast: the same values as the reference's cast-then-
    # gather, without converting the whole padded table per call.
    if is_dtensor(p["embedding"]):
        return _embed_on_shards(tokens, p["embedding"]).to(dtype)
    return p["embedding"][tokens].to(dtype)


def unembed(x: torch.Tensor, p: dict) -> torch.Tensor:
    w = p.get("unembed", p["embedding"])
    return token_einsum("...d,vd->...v", x, w.to(x.dtype))
