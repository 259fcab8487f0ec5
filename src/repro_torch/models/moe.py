"""Mixture-of-Experts: token-choice top-k, capacity-bounded slot dispatch.

The port's copy of ``repro.models.moe``:

  1. router softmax -> top-k (expert, weight) per token — a stable
     descending sort, so ties keep the lower expert first as
     ``lax.top_k`` does;
  2. rank tokens within each expert (stable sort, bincount/cumsum
     starts), drop beyond capacity;
  3. scatter tokens into an [E*C, D] slot buffer (one value per slot);
  4. one batched einsum per matrix over all experts;
  5. weighted combine back to token positions, adding each token's k
     contributions in order (the reference's sequential scatter-add),
     which also keeps the result deterministic on the card.

Aux losses: switch-style load balance + router z-loss.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.distributed.constraints import maybe_shard


def moe_params(draw, cfg) -> dict:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    s_in, s_out = 1.0 / np.sqrt(d), 1.0 / np.sqrt(f)
    p = {
        "router": draw.normal((d, e), s_in),
        "w_gate": draw.normal((e, d, f), s_in),
        "w_up": draw.normal((e, d, f), s_in),
        "w_down": draw.normal((e, f, d), s_out),
    }
    if cfg.n_shared_experts:
        fs = cfg.moe_d_ff * cfg.n_shared_experts
        p["shared"] = {
            "w_gate": draw.normal((d, fs), s_in),
            "w_up": draw.normal((d, fs), s_in),
            "w_down": draw.normal((fs, d), s_out),
        }
    return p


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k``: the k largest along the last axis, descending, ties
    in index order."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_ffn(cfg, p: dict, x: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """x: [B, T, D] -> (y, aux) with aux = {load_balance_loss, z_loss}."""
    b, t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    xf = x.reshape(b * t, d)
    n = b * t
    cap = int(np.ceil(n * k / e * cfg.capacity_factor))
    dev = x.device

    logits = torch.einsum("nd,de->ne", xf, p["router"].to(x.dtype))
    logits32 = logits.float()
    probs = torch.softmax(logits32, dim=-1)
    top_w, top_e = top_k(probs, k)                               # [N, k]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)

    flat_e = top_e.reshape(-1)                                   # [N*k]
    token_of = torch.arange(n, device=dev).repeat_interleave(k)
    order = torch.sort(flat_e, stable=True).indices
    sorted_e = flat_e[order]
    counts = torch.bincount(sorted_e, minlength=e)
    starts = torch.cumsum(counts, 0) - counts
    rank_sorted = torch.arange(n * k, device=dev) - starts[sorted_e]
    rank = torch.zeros(n * k, dtype=torch.int64, device=dev)
    rank[order] = rank_sorted
    ok = rank < cap
    # Dropped entries go to slot 0 with a zero contribution.
    slot = torch.where(ok, flat_e * cap + rank, 0)
    okf = ok.to(x.dtype)[:, None]

    buf = torch.zeros((e * cap, d), dtype=x.dtype, device=dev)
    buf.index_add_(0, slot, xf[token_of] * okf)
    buf = maybe_shard(buf, "model", None)
    h = maybe_shard(buf.reshape(e, cap, d), "model", None, None)
    g = torch.einsum("ecd,edf->ecf", h, p["w_gate"].to(x.dtype))
    u = torch.einsum("ecd,edf->ecf", h, p["w_up"].to(x.dtype))
    o = torch.einsum("ecf,efd->ecd", F.silu(g) * u, p["w_down"].to(x.dtype))
    o = maybe_shard(o, "model", None, None).reshape(e * cap, d)

    contrib = o[slot] * (top_w.reshape(-1)[:, None].to(x.dtype) * okf)
    contrib = contrib.reshape(n, k, d)
    y = torch.zeros((n, d), dtype=x.dtype, device=dev)
    for j in range(k):
        y = y + contrib[:, j]
    y = maybe_shard(y, ("pod", "data"), None)

    if cfg.n_shared_experts:
        sp = p["shared"]
        sg = torch.einsum("nd,df->nf", xf, sp["w_gate"].to(x.dtype))
        su = torch.einsum("nd,df->nf", xf, sp["w_up"].to(x.dtype))
        y = y + torch.einsum("nf,fd->nd", F.silu(sg) * su,
                             sp["w_down"].to(x.dtype))

    me = probs.mean(0)
    ce = torch.zeros(e, dtype=torch.float32, device=dev).index_add_(
        0, flat_e, torch.ones(n * k, dtype=torch.float32, device=dev)) / (n * k)
    aux = {
        "load_balance_loss": e * torch.sum(me * ce),
        "z_loss": torch.mean(torch.logsumexp(logits32, dim=-1) ** 2),
    }
    return y.reshape(b, t, d), aux
