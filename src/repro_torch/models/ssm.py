"""Mamba2 (SSD — state-space duality, arXiv:2405.21060).

The port's copy of ``repro.models.ssm``: chunked SSD (an attention-like
masked product within each chunk; the reference's ``lax.scan`` over
chunks as a Python loop carrying the [H, N, P] state in the same order),
the sequential-recurrence oracle and single-step decode. float32
internals, as the reference's.

Layer structure (Mamba2 block):
  in_proj -> [z, x, B, C, dt]; depthwise causal conv + SiLU on (x,B,C);
  SSD(x, dt, A, B, C) + D*x; y = RMSNorm(y * silu(z)); out_proj.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.layers import rms_norm


def ssm_dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    return d_inner, n_heads


def ssm_params(draw, cfg) -> dict:
    d = cfg.d_model
    d_inner, h = ssm_dims(cfg)
    n = cfg.ssm_state
    conv_ch = d_inner + 2 * n  # x + B + C (single group)
    s = 1.0 / np.sqrt(d)
    return {
        "in_proj": draw.normal((d, 2 * d_inner + 2 * n + h), s),
        "conv_w": draw.normal((cfg.ssm_conv_width, conv_ch), 0.1),
        "conv_b": draw.zeros((conv_ch,)),
        "a_log": draw.zeros((h,)),            # A = -exp(a_log)
        "d_skip": draw.ones((h,)),
        "dt_bias": draw.full((h,), -2.0),      # softplus init ~0.12
        "norm": draw.ones((d_inner,)),
        "out_proj": draw.normal((d_inner, d), 1.0 / np.sqrt(d_inner)),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + exp(x)) as ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _split_proj(cfg, p, u):
    d_inner, h = ssm_dims(cfg)
    n = cfg.ssm_state
    zxbcdt = torch.einsum("btd,de->bte", u, p["in_proj"].to(u.dtype))
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:d_inner + d_inner + 2 * n]
    dt = zxbcdt[..., -h:]
    return z, xbc, dt


def _causal_conv(p, xbc, dtype):
    """Depthwise causal conv of width W as shifted adds."""
    w = p["conv_w"].to(dtype)
    width = w.shape[0]
    pad = F.pad(xbc, (0, 0, width - 1, 0))
    t = xbc.shape[1]
    out = 0
    for k in range(width):
        out = out + pad[:, k:k + t] * w[k]
    return F.silu(out + p["conv_b"].to(dtype))


def ssd_chunked(cfg, x, dt, a_log, b, c, d_skip):
    """x: [B,T,H,P]; dt: [B,T,H]; b,c: [B,T,N]. Returns y: [B,T,H,P]."""
    bs, t, h, pdim = x.shape
    n = b.shape[-1]
    q = min(cfg.ssm_chunk, t)
    while t % q:
        q //= 2
    nc = t // q
    x32, dt32 = x.float(), dt.float()
    b32, c32 = b.float(), c.float()
    neg_a = -torch.exp(a_log.float())                     # [H]
    logdec = dt32 * neg_a[None, None]                     # [B,T,H]
    xc = x32.reshape(bs, nc, q, h, pdim)
    dtc = dt32.reshape(bs, nc, q, h)
    bc = b32.reshape(bs, nc, q, n)
    cc = c32.reshape(bs, nc, q, n)
    lc = logdec.reshape(bs, nc, q, h)
    cum = torch.cumsum(lc, dim=2)                         # [B,nc,Q,H]
    total = cum[:, :, -1]                                 # [B,nc,H]

    # Intra-chunk (attention-like, causal).
    rel = cum[:, :, :, None] - cum[:, :, None, :]         # [B,nc,t,s,H]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    # Masked before the exp: above the diagonal ``rel`` is a positive decay
    # sum that can overflow, and exp's backward would make 0 * inf = NaN
    # there (the reference's order, ``where(mask, exp(rel), 0)``, does).
    att = torch.exp(torch.where(mask[None, None, :, :, None], rel,
                                float("-inf")))
    gbc = torch.einsum("bcin,bcjn->bcij", cc, bc)         # C[t].B[s]
    w_ts = att * gbc[..., None] * dtc[:, :, None]         # [B,nc,t,s,H]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", w_ts, xc)

    # Chunk-local states: S_c = sum_s exp(total - cum[s]) dt[s] B[s] (x) x[s]
    sdec = torch.exp(total[:, :, None] - cum)             # [B,nc,Q,H]
    s_loc = torch.einsum("bcjh,bcjn,bcjhp->bchnp", sdec * dtc, bc, xc)

    # Inter-chunk recurrence: S_c = exp(total_{c-1}) S_{c-1} + S_loc_{c-1}
    state = torch.zeros((bs, h, n, pdim), dtype=torch.float32,
                        device=x.device)
    prevs = []
    for ci in range(nc):
        prevs.append(state)                               # state BEFORE chunk
        state = torch.exp(total[:, ci])[..., None, None] * state \
            + s_loc[:, ci]
    s_prev = torch.stack(prevs, dim=1)                    # [B,nc,H,N,P]

    # Inter-chunk output: y[t] += C[t] . (exp(cum[t]) * S_prev), the decay
    # taken out of the contraction (no [B,nc,Q,H,N,P] product is formed).
    y_inter = torch.exp(cum)[..., None] * torch.einsum(
        "bcin,bchnp->bcihp", cc, s_prev)
    y = (y_intra + y_inter).reshape(bs, t, h, pdim)
    y = y + d_skip.float()[None, None, :, None] * x32
    return y.to(x.dtype)


def _conv_split(cfg, p, u):
    d_inner, h = ssm_dims(cfg)
    n = cfg.ssm_state
    z, xbc, dtraw = _split_proj(cfg, p, u)
    xbc = _causal_conv(p, xbc, u.dtype)
    x = xbc[..., :d_inner]
    b = xbc[..., d_inner:d_inner + n]
    c = xbc[..., d_inner + n:]
    dt = softplus(dtraw.float() + p["dt_bias"][None, None].float())
    return z, x, b, c, dt


def ssm_forward(cfg, p: dict, u: torch.Tensor) -> torch.Tensor:
    """Full-sequence Mamba2 block. u: [B,T,D] -> [B,T,D]."""
    d_inner, h = ssm_dims(cfg)
    z, x, b, c, dt = _conv_split(cfg, p, u)
    bs, t, _ = u.shape
    xh = x.reshape(bs, t, h, cfg.ssm_head_dim)
    y = ssd_chunked(cfg, xh, dt, p["a_log"], b, c, p["d_skip"])
    y = y.reshape(bs, t, d_inner)
    y = rms_norm(y * F.silu(z), p["norm"])
    return torch.einsum("bte,ed->btd", y, p["out_proj"].to(u.dtype))


def ssm_naive(cfg, p: dict, u: torch.Tensor) -> torch.Tensor:
    """Sequential-recurrence oracle (tests: chunked == naive)."""
    d_inner, h = ssm_dims(cfg)
    n = cfg.ssm_state
    z, x, b, c, dt = _conv_split(cfg, p, u)
    bs, t, _ = u.shape
    pdim = cfg.ssm_head_dim
    xh = x.reshape(bs, t, h, pdim).float()
    neg_a = -torch.exp(p["a_log"].float())
    b32, c32 = b.float(), c.float()
    state = torch.zeros((bs, h, n, pdim), dtype=torch.float32,
                        device=u.device)
    ys = []
    for i in range(t):
        a_t = torch.exp(dt[:, i] * neg_a[None])           # [B,H]
        state = (a_t[..., None, None] * state
                 + torch.einsum("bh,bn,bhp->bhnp", dt[:, i], b32[:, i],
                                xh[:, i]))
        ys.append(torch.einsum("bn,bhnp->bhp", c32[:, i], state))
    y = torch.stack(ys, dim=1)
    y = y + p["d_skip"].float()[None, None, :, None] * xh
    y = y.reshape(bs, t, d_inner).to(u.dtype)
    y = rms_norm(y * F.silu(z), p["norm"])
    return torch.einsum("bte,ed->btd", y, p["out_proj"].to(u.dtype))


def final_state(x, dt, a_log, b, state):
    """The SSM state after the tokens of ``x`` ([B,T,H,P]; ``dt``
    [B,T,H], ``b`` [B,T,N], float32) from ``state`` ([B,H,N,P]): the
    per-token recurrence ``S <- exp(dt_t A) S + dt_t B_t (x) x_t``
    (:func:`final_state_naive`) in closed form,

        S_T = exp(sum_t dt_t A) S_0 + sum_i exp(sum_{j>i} dt_j A) dt_i B_i (x) x_i.

    The decay sums run from the last token back (flip, cumsum, flip), so
    the weights of the tokens that matter, the last ones, are short sums:
    no ``cum_T - cum_i`` cancels, whatever ``T``."""
    neg_a = -torch.exp(a_log.float())
    logdec = dt * neg_a[None, None]                       # [B,T,H]
    from_i = torch.flip(torch.cumsum(torch.flip(logdec, [1]), 1), [1])
    after_i = F.pad(from_i[:, 1:], (0, 0, 0, 1))          # sum over j > i
    xw = x * (torch.exp(after_i) * dt)[..., None]         # [B,T,H,P]
    return (torch.exp(from_i[:, 0])[..., None, None] * state
            + torch.einsum("btn,bthp->bhnp", b, xw))


def final_state_naive(x, dt, a_log, b, state):
    """:func:`final_state` token by token, as the reference's
    ``lax.scan`` runs it (the oracle of tests and ``chip_smoke.py``)."""
    neg_a = -torch.exp(a_log.float())
    for i in range(x.shape[1]):
        a_t = torch.exp(dt[:, i] * neg_a[None])
        state = (a_t[..., None, None] * state
                 + torch.einsum("bh,bn,bhp->bhnp", dt[:, i], b[:, i],
                                x[:, i]))
    return state


# ----------------------------------------------------------------------- #
# Decode (single step)
# ----------------------------------------------------------------------- #

def ssm_init_cache(cfg, batch: int, dtype=torch.float32,
                   device="cuda") -> dict:
    d_inner, h = ssm_dims(cfg)
    n = cfg.ssm_state
    conv_ch = d_inner + 2 * n
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, conv_ch),
                            dtype=dtype, device=device),
        "state": torch.zeros((batch, h, n, cfg.ssm_head_dim),
                             dtype=torch.float32, device=device),
    }


def ssm_decode(cfg, p: dict, u: torch.Tensor, cache: dict):
    """u: [B,1,D] -> (y [B,1,D], new_cache). O(1) per token."""
    d_inner, h = ssm_dims(cfg)
    n = cfg.ssm_state
    pdim = cfg.ssm_head_dim
    z, xbc, dtraw = _split_proj(cfg, p, u)
    window = torch.cat([cache["conv"], xbc], dim=1)      # [B,W,C]
    w = p["conv_w"].to(u.dtype)
    conv_out = torch.einsum("bwc,wc->bc", window, w) + p["conv_b"].to(u.dtype)
    xbc_t = F.silu(conv_out)
    new_conv = window[:, 1:]
    x = xbc_t[:, :d_inner].reshape(-1, h, pdim).float()
    b = xbc_t[:, d_inner:d_inner + n].float()
    c = xbc_t[:, d_inner + n:].float()
    dt = softplus(dtraw[:, 0].float() + p["dt_bias"][None].float())
    neg_a = -torch.exp(p["a_log"].float())
    a_t = torch.exp(dt * neg_a[None])
    state = (a_t[..., None, None] * cache["state"]
             + torch.einsum("bh,bn,bhp->bhnp", dt, b, x))
    y = torch.einsum("bn,bhnp->bhp", c, state)
    y = y + p["d_skip"][None, :, None].float() * x
    y = y.reshape(-1, 1, d_inner).to(u.dtype)
    y = rms_norm(y * F.silu(z), p["norm"])
    y = torch.einsum("bte,ed->btd", y, p["out_proj"].to(u.dtype))
    return y, {"conv": new_conv, "state": state}
