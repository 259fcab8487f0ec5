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

The scatters start from ``new_zeros`` of a tensor of the dispatch and
are out of place, so on a batch sharded as a DTensor (``launch/steps.py``
``Cell.run``) they give DTensors laid out as DTensor propagates them
(its in-place ``index_add_`` can relabel a layout without moving the
data) and the dispatch integers are those of the whole batch; on plain
tensors they are the same values.
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


def capacity(cfg, n: int) -> int:
    """Slots per expert for ``n`` tokens: ceil(n k / E * capacity_factor)."""
    return int(np.ceil(n * cfg.top_k / cfg.n_experts * cfg.capacity_factor))


def dispatch(flat_e: torch.Tensor, e: int, cap: int
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Each (token, choice) entry's rank among its expert's entries in
    flat order, and whether it keeps a slot (``rank < cap``); the rest
    are dropped."""
    n_k = flat_e.shape[0]
    order = torch.sort(flat_e, stable=True).indices
    sorted_e = flat_e[order]
    # Counts by index_add, not bincount: the same integers, but bincount
    # reads the maximum on the host first (a sync on a card) and has no
    # meta kernel, so the dry run could not trace the MoE archs.
    counts = sorted_e.new_zeros(e).index_add(0, sorted_e,
                                             torch.ones_like(sorted_e))
    starts = torch.cumsum(counts, 0) - counts
    rank_sorted = torch.arange(n_k, device=flat_e.device) - starts[sorted_e]
    rank = rank_sorted.new_zeros(n_k).scatter(0, order, rank_sorted)
    return rank, rank < cap


def moe_ffn(cfg, p: dict, x: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """x: [B, T, D] -> (y, aux) with aux = {load_balance_loss, z_loss}."""
    b, t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    xf = x.reshape(b * t, d)
    n = b * t
    cap = capacity(cfg, n)
    dev = x.device

    logits = torch.einsum("nd,de->ne", xf, p["router"].to(x.dtype))
    logits32 = logits.float()
    probs = torch.softmax(logits32, dim=-1)
    top_w, top_e = top_k(probs, k)                               # [N, k]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)

    flat_e = top_e.reshape(-1)                                   # [N*k]
    token_of = torch.arange(n, device=dev).repeat_interleave(k)
    rank, ok = dispatch(flat_e, e, cap)
    # Dropped entries go to slot 0 with a zero contribution.
    slot = torch.where(ok, flat_e * cap + rank, 0)
    okf = ok.to(x.dtype)[:, None]

    buf = xf.new_zeros((e * cap, d)).index_add(0, slot,
                                               xf[token_of] * okf)
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
        # Pinned again (an identity with no mesh): DTensor may leave the
        # sum's tokens split over the model axis as well, a layout the
        # [B, T, D] reshape below cannot take.
        y = maybe_shard(y, ("pod", "data"), None)

    me = probs.mean(0)
    ce = probs.new_zeros(e).index_add(
        0, flat_e, torch.ones(n * k, dtype=torch.float32, device=dev)) / (n * k)
    aux = {
        "load_balance_loss": e * torch.sum(me * ce),
        "z_loss": torch.mean(torch.logsumexp(logits32, dim=-1) ** 2),
    }
    return y.reshape(b, t, d), aux
