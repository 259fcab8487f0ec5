"""GQA attention (QKV bias, QK-norm, sliding window) with KV-cache decode.

The port's copy of ``repro.models.attention``: the dense path, the
online-softmax chunked path (the reference's ``lax.scan`` over KV blocks
as a Python loop with the same carry order, since the rescaling is
order-sensitive in float32) and ring-buffered decode. Where the reference
divides a low-precision product by a NumPy scalar (which promotes it to
float32 in JAX), the port upcasts explicitly at the same point.

Decode writes the new K/V into the caller's cache tensors in place
(JAX's ``.at[].set`` makes a copy) and returns them.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.layers import apply_rope, rms_norm

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
    q = torch.einsum("btd,dhk->bthk", x, p["wq"].to(x.dtype))
    k = torch.einsum("btd,dhk->bthk", x, p["wk"].to(x.dtype))
    v = torch.einsum("btd,dhk->bthk", x, p["wv"].to(x.dtype))
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
        if k.shape[1] >= CHUNKED_SDPA_THRESHOLD:
            out = _sdpa_chunked(q, k, v, causal=False, window=0)
        else:
            mask = torch.zeros((q.shape[1], k.shape[1]), dtype=torch.float32,
                               device=x.device)
            out = _sdpa(q, k, v, mask)
    else:
        w = cfg.sliding_window if window is None else window
        if k.shape[1] >= CHUNKED_SDPA_THRESHOLD:
            out = _sdpa_chunked(q, k, v, causal=causal, window=w)
        else:
            out = _sdpa(q, k, v, _mask(q.shape[1], k.shape[1], causal, w,
                                       device=x.device))
    return torch.einsum("bthk,hkd->btd", out, p["wo"].to(x.dtype))


def attention_prefill(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor,
                      window: int | None = None):
    """Returns (out, (k_cache, v_cache)) for serving prefill."""
    q, k, v = _project_qkv(cfg, p, x, positions)
    w = cfg.sliding_window if window is None else window
    if k.shape[1] >= CHUNKED_SDPA_THRESHOLD:
        out = _sdpa_chunked(q, k, v, causal=True, window=w)
    else:
        out = _sdpa(q, k, v, _mask(q.shape[1], k.shape[1], True, w,
                                   device=x.device))
    return torch.einsum("bthk,hkd->btd", out, p["wo"].to(x.dtype)), (k, v)


def ring_mask(pos: torch.Tensor, c: int, window: int = 0) -> torch.Tensor:
    """[B, C] bool: which of the C ring slots hold a position the query at
    absolute ``pos`` may attend to. Slot i holds pos - ((pos - i) mod C)."""
    kpos = torch.arange(c, device=pos.device)[None, :]
    slot_pos = pos[:, None] - ((pos[:, None] - kpos) % c)
    ok = slot_pos >= 0
    if window and window > 0:
        ok = ok & (slot_pos > pos[:, None] - window)
    return ok


def attention_decode(cfg, p: dict, x: torch.Tensor, pos: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor,
                     window: int | None = None):
    """One-token decode. x: [B, 1, D]; pos: [B] current absolute position;
    cache_k/v: [B, C, Hkv, dh], ring-buffered (C = full seq for global
    layers, C = window for SWA layers), written in place. Returns
    (out [B,1,D], cache_k, cache_v)."""
    b = x.shape[0]
    q, k, v = _project_qkv(cfg, p, x, pos[:, None])
    c = cache_k.shape[1]
    idx = pos % c
    rows = torch.arange(b, device=x.device)
    cache_k[rows, idx] = k[:, 0].to(cache_k.dtype)
    cache_v[rows, idx] = v[:, 0].to(cache_v.dtype)
    w = cfg.sliding_window if window is None else window
    mask = torch.where(ring_mask(pos, c, w), 0.0, NEG_INF).to(
        torch.float32)[:, None, None, None, :]        # b h g t s
    hkv = cache_k.shape[2]
    g = cfg.n_heads // hkv
    dh = cfg.resolved_head_dim
    qr = q.reshape(b, 1, hkv, g, dh)
    logits = torch.einsum("bthgk,bshk->bhgts", qr,
                          cache_k).float() / np.sqrt(dh)
    logits = logits + mask
    probs = torch.softmax(logits, dim=-1).to(cache_v.dtype)
    out = torch.einsum("bhgts,bshk->bthgk", probs, cache_v).reshape(
        b, 1, cfg.n_heads, dh)
    out = torch.einsum("bthk,hkd->btd", out, p["wo"].to(x.dtype))
    return out, cache_k, cache_v
