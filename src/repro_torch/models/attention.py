"""GQA attention (QKV bias, QK-norm, sliding window) with KV-cache decode.

The port's copy of ``repro.models.attention``: the dense path, the
online-softmax chunked path (the reference's ``lax.scan`` over KV blocks
as a Python loop with the same carry order, since the rescaling is
order-sensitive in float32) and ring-buffered decode. Where the reference
divides a low-precision product by a NumPy scalar (which promotes it to
float32 in JAX), the port upcasts explicitly at the same point.

Decode writes the new K/V into the caller's cache tensors in place
(JAX's ``.at[].set`` makes a copy) and returns them; :func:`write_slots`
also writes a DTensor cache, however it is sharded. Under
``cfg.serve_seq_parallel`` the prefill gathers K/V over the ``model``
axis (``distributed/constraints.py``; an identity with no mesh).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.distributed.constraints import is_dtensor, maybe_shard
from repro_torch.models.layers import (apply_rope, contiguous_stride,
                                       rms_norm, token_einsum)

NEG_INF = -1e30


def gqa_params(draw, cfg) -> dict:
    d, h, hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    dh = cfg.resolved_head_dim
    s = 1.0 / np.sqrt(d)
    p = {
        "wq": draw.normal((d, h, dh), s),
        "wk": draw.normal((d, hkv, dh), s),
        "wv": draw.normal((d, hkv, dh), s),
        "wo": draw.normal((h, dh, d), 1.0 / np.sqrt(h * dh)),
    }
    if cfg.qkv_bias:
        p["bq"] = draw.zeros((h, dh))
        p["bk"] = draw.zeros((hkv, dh))
        p["bv"] = draw.zeros((hkv, dh))
    if cfg.qk_norm:
        p["q_norm"] = draw.ones((dh,))
        p["k_norm"] = draw.ones((dh,))
    return p


def _project_qkv(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor):
    q = token_einsum("btd,dhk->bthk", x, p["wq"].to(x.dtype))
    k = token_einsum("btd,dhk->bthk", x, p["wk"].to(x.dtype))
    v = token_einsum("btd,dhk->bthk", x, p["wv"].to(x.dtype))
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _mask(t: int, s: int, causal: bool, window, q_offset: int = 0,
          device=None) -> torch.Tensor:
    """[t, s] float32 additive mask; query i is at absolute position
    q_offset + i. window <= 0 means full attention."""
    qpos = torch.arange(t, device=device)[:, None] + q_offset
    kpos = torch.arange(s, device=device)[None, :]
    ok = torch.ones((t, s), dtype=torch.bool, device=device)
    if causal:
        ok = ok & (kpos <= qpos)
    window = int(window)
    if window > 0:
        ok = ok & (kpos > qpos - window)
    return torch.where(ok, 0.0, NEG_INF).to(torch.float32)


# KV sequence lengths at or above this use the chunked (flash-style) path.
CHUNKED_SDPA_THRESHOLD = 8192
KV_BLOCK = 1024


def _sdpa_dense(q, k, v, mask):
    """q:[B,T,H,dh] k,v:[B,S,Hkv,dh]; grouped heads; fp32 softmax."""
    b, t, h, dh = q.shape
    hkv = k.shape[2]
    g = h // hkv
    q = q.reshape(b, t, hkv, g, dh)
    logits = torch.einsum("bthgk,bshk->bhgts", q, k).float() / np.sqrt(dh)
    logits = logits + mask
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhgts,bshk->bthgk", probs, v)
    return out.reshape(b, t, h, dh)


def _sdpa_chunked(q, k, v, causal: bool, window, q_offset: int = 0,
                  kv_block: int = KV_BLOCK):
    """Flash-style online-softmax attention over KV blocks, in block
    order; never materializes the [T, S] logits."""
    b, t, h, dh = q.shape
    s = k.shape[1]
    hkv = k.shape[2]
    g = h // hkv
    if s % kv_block:
        pad = kv_block - s % kv_block
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    nb = k.shape[1] // kv_block
    qr = (q.reshape(b, t, hkv, g, dh).float() / np.sqrt(dh)).to(q.dtype)
    dev = q.device
    qpos = torch.arange(t, device=dev) + q_offset
    window = int(window)
    m = torch.full((b, hkv, g, t), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hkv, g, t), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, g, t, dh), dtype=torch.float32, device=dev)
    for i in range(nb):
        start = i * kv_block
        k_blk = k[:, start:start + kv_block]
        v_blk = v[:, start:start + kv_block]
        logits = torch.einsum("bthgk,bshk->bhgts", qr, k_blk).float()
        kpos = start + torch.arange(kv_block, device=dev)
        ok = kpos[None, :] < s
        if causal:
            ok = ok & (kpos[None, :] <= qpos[:, None])
        if window > 0:
            ok = ok & (kpos[None, :] > qpos[:, None] - window)
        logits = torch.where(ok[None, None, None], logits, NEG_INF)
        m_blk = logits.amax(dim=-1)
        m_new = torch.maximum(m, m_blk)
        p = torch.exp(logits - m_new[..., None])
        scale = torch.exp(m - m_new)
        l = l * scale + p.sum(-1)
        acc = acc * scale[..., None] + torch.einsum(
            "bhgts,bshk->bhgtk", p.to(v_blk.dtype), v_blk).float()
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    out = torch.movedim(out, 3, 1)            # [B,T,Hkv,G,dh]
    return out.reshape(b, t, h, dh).to(q.dtype)


def _sdpa(q, k, v, mask):
    return _sdpa_dense(q, k, v, mask)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward hands on a contiguous gradient: a
    rank's local tensor must match the DTensor's (contiguous) layout."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def on_shards(core, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """``core(q, k, v, t0, b0)`` -> [B, T, H, dh]: the attention core on
    whole tensors (``t0 = b0 = 0``) or, for DTensors, on each rank's own
    shard, where the work is independent: batch and KV-head-group shards
    of q, k and v alike, and a sequence shard of q (its first position
    ``t0``, its first row ``b0``) against whole keys. Any other layout is
    gathered first. The local core is plain PyTorch (no per-op DTensor
    dispatch), and its output is a DTensor laid out as q."""
    if not is_dtensor(q):
        return core(q, k, v, 0, 0)
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.distributed.sharding import shard_box
    mesh = q.device_mesh
    qp, kp = [], []
    for i, pl in enumerate(q.placements):
        if pl.is_shard(0) or (pl.is_shard(2)
                              and k.shape[2] % mesh.size(i) == 0):
            qp.append(pl)
            kp.append(pl)
        elif pl.is_shard(1):   # sequence-parallel queries, whole keys
            qp.append(pl)
            kp.append(Replicate())
        else:
            qp.append(Replicate())
            kp.append(Replicate())

    def laid(x, pl):
        if not isinstance(x, DTensor):
            x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim)
        return x.redistribute(mesh, pl)

    q, k, v = laid(q, qp), laid(k, kp), laid(v, kp)
    box = shard_box(q)
    local = [_ContiguousGrad.apply(x.to_local()) for x in (q, k, v)]
    out = core(*local, box[1][0], box[0][0]).contiguous()
    return DTensor.from_local(out, mesh, qp, shape=q.shape,
                              stride=contiguous_stride(q.shape))


def attention(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor,
              causal: bool = True, window: int | None = None,
              kv: tuple[torch.Tensor, torch.Tensor] | None = None
              ) -> torch.Tensor:
    """Full-sequence attention (train / encoder / prefill compute).

    ``kv``: cross-attention memory (enc-dec) — overrides self K/V.
    """
    q, k, v = _project_qkv(cfg, p, x, positions)
    if kv is not None:
        k, v = kv
        causal, w = False, 0
    else:
        w = cfg.sliding_window if window is None else window

    def core(q, k, v, t0, b0):
        if k.shape[1] >= CHUNKED_SDPA_THRESHOLD:
            return _sdpa_chunked(q, k, v, causal=causal, window=w,
                                 q_offset=t0)
        return _sdpa(q, k, v, _mask(q.shape[1], k.shape[1], causal, w,
                                    q_offset=t0, device=q.device))

    out = on_shards(core, q, k, v)
    return token_einsum("bthk,hkd->btd", out, p["wo"].to(x.dtype))


def attention_prefill(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor,
                      window: int | None = None):
    """Returns (out, (k_cache, v_cache)) for serving prefill."""
    q, k, v = _project_qkv(cfg, p, x, positions)
    if cfg.serve_seq_parallel:
        # SP serving: q stays sequence-sharded; K/V gather across the
        # model axis (the one collective of the scheme).
        k = maybe_shard(k, ("pod", "data"), None, None, None)
        v = maybe_shard(v, ("pod", "data"), None, None, None)
    w = cfg.sliding_window if window is None else window

    def core(q, k, v, t0, b0):
        if k.shape[1] >= CHUNKED_SDPA_THRESHOLD:
            return _sdpa_chunked(q, k, v, causal=True, window=w,
                                 q_offset=t0)
        return _sdpa(q, k, v, _mask(q.shape[1], k.shape[1], True, w,
                                    q_offset=t0, device=q.device))

    out = on_shards(core, q, k, v)
    return token_einsum("bthk,hkd->btd", out, p["wo"].to(x.dtype)), (k, v)


def ring_mask(pos: torch.Tensor, c: int, window: int = 0) -> torch.Tensor:
    """[B, C] bool: which of the C ring slots hold a position the query at
    absolute ``pos`` may attend to. Slot i holds pos - ((pos - i) mod C)."""
    kpos = torch.arange(c, device=pos.device)[None, :]
    slot_pos = pos[:, None] - ((pos[:, None] - kpos) % c)
    ok = slot_pos >= 0
    if window and window > 0:
        ok = ok & (slot_pos > pos[:, None] - window)
    return ok


def write_slots(cache: torch.Tensor, idx: torch.Tensor,
                value: torch.Tensor, rows: torch.Tensor | None = None
                ) -> torch.Tensor:
    """``cache[b, idx[b]] = value[b]`` for every row ``b``, in place
    (cache ``[B, C, ...]``, idx ``[B]``, value ``[B, ...]``; ``rows``, the
    plain path's ``arange(B)``, may be passed to share it between
    caches); returns ``cache``. A DTensor cache (in-place indexing cannot
    change its layout) is written on each rank's own shard: the rows and
    ring slots it holds, from the full ``idx`` and ``value``."""
    if not is_dtensor(cache):
        if rows is None:
            rows = torch.arange(cache.shape[0], device=cache.device)
        cache[rows, idx] = value.to(cache.dtype)
        return cache
    from repro_torch.distributed.sharding import shard_box

    def full(t):
        return t.full_tensor() if is_dtensor(t) else t

    local = cache.to_local()
    box = shard_box(cache)
    (b0, nb), (c0, nc) = box[0], box[1]
    if nb == 0 or nc == 0:
        return cache
    gi = full(idx)[b0:b0 + nb].to(local.device)
    v = full(value).to(local.device, cache.dtype)[b0:b0 + nb]
    v = v[(slice(None),) + tuple(slice(s, s + n) for s, n in box[2:])]
    keep = ((gi >= c0) & (gi < c0 + nc)).view(-1, *[1] * (v.ndim - 1))
    rows = torch.arange(nb, device=local.device)
    slot = (gi - c0).clamp(0, nc - 1)
    local[rows, slot] = torch.where(keep, v, local[rows, slot])
    return cache


def attention_decode(cfg, p: dict, x: torch.Tensor, pos: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor,
                     window: int | None = None):
    """One-token decode. x: [B, 1, D]; pos: [B] current absolute position;
    cache_k/v: [B, C, Hkv, dh], ring-buffered (C = full seq for global
    layers, C = window for SWA layers), written in place. Returns
    (out [B,1,D], cache_k, cache_v)."""
    q, k, v = _project_qkv(cfg, p, x, pos[:, None])
    c = cache_k.shape[1]
    idx = pos % c
    sharded = is_dtensor(cache_k)
    rows = None if sharded else torch.arange(x.shape[0], device=x.device)
    write_slots(cache_k, idx, k[:, 0], rows)
    write_slots(cache_v, idx, v[:, 0], rows)
    w = cfg.sliding_window if window is None else window
    whole_pos = pos.full_tensor() if is_dtensor(pos) else pos

    def core(q, cache_k, cache_v, t0, b0):
        b, _, h, dh = q.shape
        hkv = cache_k.shape[2]
        mask = torch.where(ring_mask(whole_pos[b0:b0 + b].to(q.device), c,
                                     w), 0.0, NEG_INF).to(
            torch.float32)[:, None, None, None, :]        # b h g t s
        qr = q.reshape(b, 1, hkv, h // hkv, dh)
        logits = torch.einsum("bthgk,bshk->bhgts", qr,
                              cache_k).float() / np.sqrt(dh)
        logits = logits + mask
        probs = torch.softmax(logits, dim=-1).to(cache_v.dtype)
        return torch.einsum("bhgts,bshk->bthgk", probs, cache_v).reshape(
            b, 1, h, dh)

    out = on_shards(core, q, cache_k, cache_v)
    out = token_einsum("bthk,hkd->btd", out, p["wo"].to(x.dtype))
    return out, cache_k, cache_v
