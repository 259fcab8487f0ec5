"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434).

The port's copy of ``repro.models.mla``: K/V compressed into a
``kv_lora_rank`` latent plus one shared RoPE key head; train/prefill
decompress to per-head K/V (chunked online softmax over latent blocks
when long, a Python loop in the reference's block order, a tile of
queries at a time); decode scores against the cached latent directly
(absorbed) or decompresses it each step (naive). Decode writes the
caches in place.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.distributed.constraints import is_dtensor
from repro_torch.models.attention import ring_mask, write_slots
from repro_torch.models.layers import apply_rope, rms_norm

NEG_INF = -1e30


def mla_params(draw, cfg) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    dq, dkv = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    s = 1.0 / np.sqrt(d)
    return {
        "w_dq": draw.normal((d, dq), s),
        "q_norm": draw.ones((dq,)),
        "w_uq": draw.normal((dq, h, dn + dr), 1.0 / np.sqrt(dq)),
        "w_dkv": draw.normal((d, dkv), s),
        "kv_norm": draw.ones((dkv,)),
        "w_kr": draw.normal((d, dr), s),
        "w_uk": draw.normal((dkv, h, dn), 1.0 / np.sqrt(dkv)),
        "w_uv": draw.normal((dkv, h, dv), 1.0 / np.sqrt(dkv)),
        "wo": draw.normal((h, dv, d), 1.0 / np.sqrt(h * dv)),
    }


def _q_proj(cfg, p, x, positions):
    cq = rms_norm(torch.einsum("btd,dr->btr", x, p["w_dq"].to(x.dtype)),
                  p["q_norm"])
    q = torch.einsum("btr,rhk->bthk", cq, p["w_uq"].to(x.dtype))
    dn = cfg.qk_nope_head_dim
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    return q_nope, q_rope


def _kv_latent(cfg, p, x, positions):
    c_kv = rms_norm(torch.einsum("btd,dr->btr", x, p["w_dkv"].to(x.dtype)),
                    p["kv_norm"])
    k_rope = torch.einsum("btd,dr->btr", x, p["w_kr"].to(x.dtype))
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0]
    return c_kv, k_rope


CHUNKED_THRESHOLD = 8192
KV_BLOCK = 1024
Q_TILE = 4096


def _mla_chunked(cfg, p, q_nope, q_rope, c_kv, k_rope, kv_block=KV_BLOCK,
                 q_tile=Q_TILE):
    """Online softmax over latent KV blocks, decompressing K/V per block,
    ``q_tile`` queries at a time: each tile goes through every block in
    the reference's order with the same mask, and its ``[B, H, q_tile,
    kv_block]`` logits bound the temporaries (untiled, 32,768 queries of
    128 heads make 17 GB of float32 logits a block)."""
    t = q_nope.shape[1]
    s = c_kv.shape[1]
    scale = 1.0 / np.sqrt(q_nope.shape[-1] + cfg.qk_rope_head_dim)
    if s % kv_block:
        pad = kv_block - s % kv_block
        c_kv = torch.nn.functional.pad(c_kv, (0, 0, 0, pad))
        k_rope = torch.nn.functional.pad(k_rope, (0, 0, 0, pad))
    qn = (q_nope.float() * scale).to(q_nope.dtype)
    qr = (q_rope.float() * scale).to(q_rope.dtype)
    outs = [_mla_tile(cfg, p, qn[:, i:i + q_tile], qr[:, i:i + q_tile], i,
                      c_kv, k_rope, s, kv_block)
            for i in range(0, t, q_tile)]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def _mla_tile(cfg, p, qn, qr, q0, c_kv, k_rope, s, kv_block):
    """One query tile (positions ``q0`` on, pre-scaled) of
    :func:`_mla_chunked` over every block of the padded latent."""
    b, t, h, _ = qn.shape
    dv = cfg.v_head_dim
    nb = c_kv.shape[1] // kv_block
    dev = qn.device
    qpos = q0 + torch.arange(t, device=dev)
    m = torch.full((b, h, t), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, t), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, t, dv), dtype=torch.float32, device=dev)
    for i in range(nb):
        start = i * kv_block
        c_blk = c_kv[:, start:start + kv_block]
        r_blk = k_rope[:, start:start + kv_block]
        k_nope = torch.einsum("bsr,rhk->bshk", c_blk,
                              p["w_uk"].to(c_blk.dtype))
        v_blk = torch.einsum("bsr,rhk->bshk", c_blk,
                             p["w_uv"].to(c_blk.dtype))
        logits = (torch.einsum("bthk,bshk->bhts", qn, k_nope)
                  + torch.einsum("bthk,bsk->bhts", qr, r_blk)).float()
        kpos = start + torch.arange(kv_block, device=dev)
        ok = (kpos[None, :] <= qpos[:, None]) & (kpos[None, :] < s)
        logits = torch.where(ok[None, None], logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        pr = torch.exp(logits - m_new[..., None])
        sc = torch.exp(m - m_new)
        l = l * sc + pr.sum(-1)
        acc = acc * sc[..., None] + torch.einsum(
            "bhts,bshk->bhtk", pr.to(v_blk.dtype), v_blk).float()
        m = m_new
    out = (acc / torch.clamp(l[..., None], min=1e-30)).to(qn.dtype)
    return torch.movedim(out, 1, 2)  # [B,T,H,dv]


def mla_attention(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor,
                  chunked: bool | None = None) -> torch.Tensor:
    """Train / full-sequence path (decompressed K/V; chunked when long)."""
    b, t, _ = x.shape
    dn = cfg.qk_nope_head_dim
    q_nope, q_rope = _q_proj(cfg, p, x, positions)
    c_kv, k_rope = _kv_latent(cfg, p, x, positions)
    use_chunked = (t >= CHUNKED_THRESHOLD) if chunked is None else chunked
    if use_chunked:
        out = _mla_chunked(cfg, p, q_nope, q_rope, c_kv, k_rope)
        return torch.einsum("bthk,hkd->btd", out, p["wo"].to(x.dtype))
    k_nope = torch.einsum("btr,rhk->bthk", c_kv, p["w_uk"].to(x.dtype))
    v = torch.einsum("btr,rhk->bthk", c_kv, p["w_uv"].to(x.dtype))
    scale = 1.0 / np.sqrt(dn + cfg.qk_rope_head_dim)
    logits = (torch.einsum("bthk,bshk->bhts", q_nope, k_nope)
              + torch.einsum("bthk,bsk->bhts", q_rope, k_rope)).float() * scale
    qpos = torch.arange(t, device=x.device)
    mask = torch.where(qpos[None, :] <= qpos[:, None], 0.0, NEG_INF).to(
        torch.float32)
    probs = torch.softmax(logits + mask, dim=-1).to(v.dtype)
    out = torch.einsum("bhts,bshk->bthk", probs, v)
    return torch.einsum("bthk,hkd->btd", out, p["wo"].to(x.dtype))


def mla_prefill(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor):
    """Returns (out, (c_kv_cache, k_rope_cache)) — the compressed cache."""
    out = mla_attention(cfg, p, x, positions)
    c_kv, k_rope = _kv_latent(cfg, p, x, positions)
    return out, (c_kv, k_rope)


def mla_decode(cfg, p: dict, x: torch.Tensor, pos: torch.Tensor,
               cache_c: torch.Tensor, cache_kr: torch.Tensor,
               absorbed: bool = True):
    """One-token decode against the compressed cache (written in place).

    absorbed=True: scores and values against the latent directly;
    absorbed=False: decompress all K/V each step (the naive baseline)."""
    s = cache_c.shape[1]
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q_nope, q_rope = _q_proj(cfg, p, x, pos[:, None])   # [B,1,H,*]
    c_kv, k_rope = _kv_latent(cfg, p, x, pos[:, None])
    idx = pos % s
    rows = (None if is_dtensor(cache_c)
            else torch.arange(x.shape[0], device=x.device))
    write_slots(cache_c, idx, c_kv[:, 0], rows)
    write_slots(cache_kr, idx, k_rope[:, 0], rows)
    mask = torch.where(ring_mask(pos, s), 0.0, NEG_INF).to(
        torch.float32)[:, None, :]                       # [B,1,S]
    scale = 1.0 / np.sqrt(dn + dr)
    if absorbed:
        q_abs = torch.einsum("bhk,rhk->bhr", q_nope[:, 0],
                             p["w_uk"].to(x.dtype))
        logits = (torch.einsum("bhr,bsr->bhs", q_abs, cache_c)
                  + torch.einsum("bhk,bsk->bhs", q_rope[:, 0], cache_kr)
                  ).float() * scale
        probs = torch.softmax(logits + mask, dim=-1).to(x.dtype)
        out_c = torch.einsum("bhs,bsr->bhr", probs, cache_c)
        out = torch.einsum("bhr,rhk->bhk", out_c, p["w_uv"].to(x.dtype))
    else:
        k_nope = torch.einsum("bsr,rhk->bshk", cache_c,
                              p["w_uk"].to(x.dtype))
        v = torch.einsum("bsr,rhk->bshk", cache_c, p["w_uv"].to(x.dtype))
        logits = (torch.einsum("bhk,bshk->bhs", q_nope[:, 0], k_nope)
                  + torch.einsum("bhk,bsk->bhs", q_rope[:, 0], cache_kr)
                  ).float() * scale
        probs = torch.softmax(logits + mask, dim=-1).to(x.dtype)
        out = torch.einsum("bhs,bshk->bhk", probs, v)
    out = torch.einsum("bhk,hkd->bd", out, p["wo"].to(x.dtype))
    return out[:, None, :], cache_c, cache_kr
