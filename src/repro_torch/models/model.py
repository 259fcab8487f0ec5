"""Unified LM: dense / MoE / SSM / hybrid / enc-dec / multimodal-stub.

The port's copy of ``repro.models.model``. One parameterized architecture
covers all 10 configs of ``repro_torch.configs``:

  * decoder layers over stacked weights: ``params["layers"]`` holds every
    leaf with a leading layer axis, exactly the reference's pytree, and
    the layer loop indexes it (the reference's ``lax.scan`` over layers
    as a Python loop in the same order),
  * attention: GQA (+bias/qk-norm/SWA) or MLA or none,
  * FFN: SwiGLU, or top-k MoE (+shared experts, leading dense layers),
  * SSM: Mamba2 SSD block (pure SSM or Hymba-style parallel hybrid),
  * encoder-decoder (audio frontend stub) and VLM patch-prefix stub.

Parameters are float32 masters cast to ``cfg.dtype`` where the reference
casts them. Everything computes on the device its parameters lie on.
Decode writes attention caches in place (the reference builds new
arrays) and returns the cache tree. The same code runs on DTensors
across a mesh (``launch/steps.py`` ``Cell.run``): the sharding
constraints of ``distributed/constraints.py`` act where the reference's
do, including the sequence-parallel serving branches
(``cfg.serve_seq_parallel``).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.constraints import (gather_layer_params,
                                                 is_dtensor, maybe_shard)
from repro_torch.models import attention as attn
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.init import Draw
from repro_torch.models.layers import (apply_norm, embed, embed_params,
                                       norm_params, swiglu, swiglu_params,
                                       unembed)
from repro_torch.models.tree import tree_leaves, tree_map

Params = dict[str, Any]


def torch_dtype(name: str) -> torch.dtype:
    """``cfg.dtype`` ("bfloat16", "float32", ...) as a ``torch.dtype``."""
    return getattr(torch, str(name))


# ----------------------------------------------------------------------- #
# Init
# ----------------------------------------------------------------------- #

def _layer_params(cfg, draw: Draw, moe_layer: bool) -> Params:
    p: Params = {"ln1": norm_params(cfg, cfg.d_model, draw)}
    if not cfg.attn_free:
        if cfg.attn_kind == "mla":
            p["attn"] = mla_mod.mla_params(draw, cfg)
        else:
            p["attn"] = attn.gqa_params(draw, cfg)
    if cfg.ssm:
        p["ssm"] = ssm_mod.ssm_params(draw, cfg)
        if cfg.hybrid_parallel:
            p["branch_norm_attn"] = norm_params(cfg, cfg.d_model, draw)
            p["branch_norm_ssm"] = norm_params(cfg, cfg.d_model, draw)
    if cfg.d_ff > 0 or moe_layer:
        p["ln2"] = norm_params(cfg, cfg.d_model, draw)
        if moe_layer:
            p["moe"] = moe_mod.moe_params(draw, cfg)
        else:
            p["mlp"] = swiglu_params(draw, cfg.d_model, cfg.d_ff)
    return p


def _enc_layer_params(cfg, draw: Draw) -> Params:
    return {
        "ln1": norm_params(cfg, cfg.d_model, draw),
        "attn": attn.gqa_params(draw, cfg),
        "ln2": norm_params(cfg, cfg.d_model, draw),
        "mlp": swiglu_params(draw, cfg.d_model, cfg.d_ff),
    }


def _dec_xattn_params(cfg, draw: Draw) -> Params:
    return {"ln_x": norm_params(cfg, cfg.d_model, draw),
            "xattn": attn.gqa_params(draw, cfg)}


def init_params(cfg, generator: torch.Generator | int | None = 0,
                device="cuda") -> Params:
    """Float32 master parameters with the reference's tree, shapes and
    scales, drawn from ``generator`` (a ``torch.Generator`` on
    ``device``, or an integer seed for one) on ``device``. On the
    ``meta`` device nothing is allocated."""
    device = torch.device(device)
    if device.type == "meta":
        generator = None
    elif not isinstance(generator, torch.Generator):
        generator = torch.Generator(device=device).manual_seed(
            int(generator or 0))
    draw = Draw(generator, device)
    n_scan = cfg.n_layers - cfg.first_dense_layers
    p: Params = {
        "embed": embed_params(draw, cfg.padded_vocab, cfg.d_model,
                              cfg.tie_embeddings),
        "final_norm": norm_params(cfg, cfg.d_model, draw),
    }
    for i in range(cfg.first_dense_layers):
        p[f"dense_layer_{i}"] = _layer_params(cfg, draw, moe_layer=False)
    p["layers"] = _layer_params(cfg, draw.stacked(n_scan), moe_layer=cfg.moe)
    if cfg.encoder_decoder:
        p["enc_layers"] = _enc_layer_params(
            cfg, draw.stacked(cfg.n_encoder_layers))
        p["enc_final_norm"] = norm_params(cfg, cfg.d_model, draw)
        p["xattn_layers"] = _dec_xattn_params(cfg, draw.stacked(n_scan))
    return p


def count_params(cfg, active_only: bool = False) -> int:
    """Parameter count from shapes alone (meta tensors: no allocation)."""
    shapes = init_params(cfg, device="meta")
    total = sum(x.numel() for x in tree_leaves(shapes))
    if active_only and cfg.moe:
        moe_shapes = moe_mod.moe_params(Draw(None, "meta"), cfg)
        per_layer_expert = sum(moe_shapes[k].numel()
                               for k in ("w_gate", "w_up", "w_down"))
        n_moe_layers = cfg.n_layers - cfg.first_dense_layers
        inactive = per_layer_expert * (1 - cfg.top_k / cfg.n_experts)
        total -= int(n_moe_layers * inactive)
    return total


# ----------------------------------------------------------------------- #
# Layer bodies
# ----------------------------------------------------------------------- #

def _window_schedule(cfg) -> np.ndarray:
    """Per-layer SWA window (0 = full attention)."""
    w = np.full(cfg.n_layers, cfg.sliding_window, np.int32)
    for i in cfg.global_attn_layers:
        w[i % cfg.n_layers] = 0
    return w


def _zero_aux(device) -> dict:
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {"load_balance_loss": z, "z_loss": z}


def _attn_branch(cfg, lp, h, positions, window):
    if cfg.attn_kind == "mla":
        return mla_mod.mla_attention(cfg, lp["attn"], h, positions)
    return attn.attention(cfg, lp["attn"], h, positions, causal=True,
                          window=window)


def _ffn(cfg, lp, x, moe_layer):
    """The FFN half of a layer; returns (x, aux or None)."""
    if "ln2" not in lp:
        return x, None
    h2 = apply_norm(cfg, x, lp["ln2"])
    if moe_layer:
        y, aux = moe_mod.moe_ffn(cfg, lp["moe"], h2)
        return x + y, aux
    return x + swiglu(h2, lp["mlp"]), None


def _layer_fwd(cfg, lp: Params, x, positions, window, moe_layer: bool):
    """Returns (x, aux)."""
    h = apply_norm(cfg, x, lp["ln1"])
    if cfg.hybrid_parallel:
        a = _attn_branch(cfg, lp, h, positions, window)
        m = ssm_mod.ssm_forward(cfg, lp["ssm"], h)
        x = x + 0.5 * (apply_norm(cfg, a, lp["branch_norm_attn"])
                       + apply_norm(cfg, m, lp["branch_norm_ssm"]))
    elif cfg.ssm:
        x = x + ssm_mod.ssm_forward(cfg, lp["ssm"], h)
    else:
        x = x + _attn_branch(cfg, lp, h, positions, window)
    x, aux = _ffn(cfg, lp, x, moe_layer)
    return x, aux if aux is not None else _zero_aux(x.device)


def layer_slice(stacked: Params, i: int) -> Params:
    """Layer ``i`` of a stacked parameter (or cache) tree: views."""
    return tree_map(lambda t: t[i], stacked)


def _sum_aux(auxs: list[dict], device) -> dict:
    out = _zero_aux(device)
    for a in auxs:   # the reference's tree_map(jnp.sum) over scan outputs
        out = {k: out[k] + a[k] for k in out}
    return out


def _remat(cfg, body):
    """``body`` under ``cfg.remat == "full"``: its activations are not kept
    for the backward pass but recomputed there (the reference's
    ``jax.checkpoint`` of the same per-layer scan body)."""
    if cfg.remat != "full":
        return body
    return lambda *args: checkpoint(body, *args, use_reentrant=False)


def _decoder_stack(cfg, params, x, positions):
    """Decoder over the stacked layers (train / full-sequence path)."""
    windows = _window_schedule(cfg)
    for i in range(cfg.first_dense_layers):
        x, _ = _layer_fwd(cfg, params[f"dense_layer_{i}"], x, positions,
                          int(windows[i]), moe_layer=False)

    def body(h, j):
        lp = gather_layer_params(cfg, layer_slice(params["layers"], j))
        return _layer_fwd(cfg, lp, h, positions,
                          int(windows[cfg.first_dense_layers + j]),
                          moe_layer=cfg.moe)

    body = _remat(cfg, body)
    auxs = []
    for j in range(cfg.n_layers - cfg.first_dense_layers):
        x, aux = body(x, j)
        auxs.append(aux)
    return x, _sum_aux(auxs, x.device)


def _encoder_stack(cfg, params, frames):
    b, t = frames.shape[:2]
    positions = torch.arange(t, device=frames.device).expand(b, t)

    def body(h, j):
        lp = layer_slice(params["enc_layers"], j)
        h = h + attn.attention(cfg, lp["attn"], apply_norm(cfg, h, lp["ln1"]),
                               positions, causal=False, window=0)
        return h + swiglu(apply_norm(cfg, h, lp["ln2"]), lp["mlp"])

    body = _remat(cfg, body)
    h = frames
    for j in range(cfg.n_encoder_layers):
        h = body(h, j)
    return apply_norm(cfg, h, params["enc_final_norm"])


def _cross_attention(cfg, xp, x, positions, memory):
    """Cross attention: memory K/V projected with this layer's weights."""
    hx = apply_norm(cfg, x, xp["ln_x"])
    mk = torch.einsum("bsd,dhk->bshk", memory, xp["xattn"]["wk"].to(x.dtype))
    mv = torch.einsum("bsd,dhk->bshk", memory, xp["xattn"]["wv"].to(x.dtype))
    return x + attn.attention(cfg, xp["xattn"], hx, positions,
                              causal=False, kv=(mk, mv))


def _decoder_stack_xattn(cfg, params, x, positions, memory):
    """Enc-dec decoder: self-attn + cross-attn + FFN per layer."""
    def body(h, j):
        lp = layer_slice(params["layers"], j)
        xp = layer_slice(params["xattn_layers"], j)
        h = h + attn.attention(cfg, lp["attn"], apply_norm(cfg, h, lp["ln1"]),
                               positions, causal=True, window=0)
        h = _cross_attention(cfg, xp, h, positions, memory)
        return h + swiglu(apply_norm(cfg, h, lp["ln2"]), lp["mlp"])

    body = _remat(cfg, body)
    for j in range(cfg.n_layers - cfg.first_dense_layers):
        x = body(x, j)
    return x, _zero_aux(x.device)


# ----------------------------------------------------------------------- #
# Full-sequence forward
# ----------------------------------------------------------------------- #

def forward(cfg, params: Params, batch: dict) -> tuple[torch.Tensor, dict]:
    """Returns (logits [B,T,paddedV], aux)."""
    dtype = torch_dtype(cfg.dtype)
    tokens = batch["tokens"]
    x = embed(tokens, params["embed"], dtype)
    if cfg.encoder_decoder:
        memory = _encoder_stack(cfg, params, batch["frames"].to(dtype))
        positions = torch.arange(tokens.shape[1],
                                 device=x.device).expand(tokens.shape)
        x, aux = _decoder_stack_xattn(cfg, params, x, positions, memory)
    else:
        if cfg.frontend == "vision" and "patches" in batch:
            x = torch.cat([batch["patches"].to(dtype), x], dim=1)
        positions = torch.arange(x.shape[1],
                                 device=x.device).expand(x.shape[:2])
        x, aux = _decoder_stack(cfg, params, x, positions)
    x = apply_norm(cfg, x, params["final_norm"])
    return unembed(x, params["embed"]), aux


def loss_fn(cfg, params: Params, batch: dict, *, z_loss: float = 1e-4,
            moe_aux: float = 1e-2) -> tuple[torch.Tensor, dict]:
    """Next-token cross entropy; batch['tokens'] is [B, T+1]. Autograd
    differentiates it end to end (``repro_torch.train.trainer``)."""
    tokens = batch["tokens"]
    inner = dict(batch)
    inner["tokens"] = tokens[:, :-1]
    logits, aux = forward(cfg, params, inner)
    labels = tokens[:, 1:]
    if cfg.frontend == "vision" and "patches" in batch:
        logits = logits[:, batch["patches"].shape[1]:]
    logits = maybe_shard(logits.float(), ("pod", "data"), None, "model")
    vocab_ids = torch.arange(cfg.padded_vocab, device=logits.device)
    logits = torch.where(vocab_ids < cfg.vocab_size, logits, -1e30)
    logz = torch.logsumexp(logits, dim=-1)
    onehot = labels[..., None] == vocab_ids
    gold = torch.sum(torch.where(onehot, logits, 0.0), dim=-1)
    nll = (logz - gold).mean()
    total = nll + z_loss * torch.mean(logz ** 2)
    metrics = {"nll": nll, "ppl_log": nll}
    if cfg.moe:
        total = total + moe_aux * aux["load_balance_loss"] \
            + 1e-3 * aux["z_loss"]
        metrics["moe_lb"] = aux["load_balance_loss"]
    return total, metrics


# ----------------------------------------------------------------------- #
# Serving: prefill + decode.
#
# Two cache layouts, as the reference's:
#   * UNIFORM archs (same attention kind + window on every layer; no
#     enc-dec/hybrid): caches are STACKED tensors [L, B, ...] beside a
#     "dense" list for leading dense (deepseek/moonshot) layers;
#   * heterogeneous archs (hymba per-layer windows, seamless enc-dec):
#     a per-layer list of dicts.
# ----------------------------------------------------------------------- #

def _resolved_layer(cfg, params: Params, i: int) -> tuple[Params, bool]:
    if i < cfg.first_dense_layers:
        return params[f"dense_layer_{i}"], False
    return layer_slice(params["layers"], i - cfg.first_dense_layers), cfg.moe


def uniform_serving(cfg) -> bool:
    windows = _window_schedule(cfg)
    return (not cfg.hybrid_parallel and not cfg.encoder_decoder
            and len(set(int(w) for w in windows)) == 1)


def _one_layer_cache(cfg, batch: int, max_len: int, window: int, dtype,
                     device, lead: tuple[int, ...] = ()) -> dict:
    def zeros(*shape):
        return torch.zeros(lead + shape, dtype=dtype, device=device)

    c: dict = {}
    dh = cfg.resolved_head_dim
    if not cfg.attn_free:
        if cfg.attn_kind == "mla":
            c["c_kv"] = zeros(batch, max_len, cfg.kv_lora_rank)
            c["k_rope"] = zeros(batch, max_len, cfg.qk_rope_head_dim)
        else:
            size = max_len if window == 0 else min(max_len, window)
            c["k"] = zeros(batch, size, cfg.n_kv_heads, dh)
            c["v"] = zeros(batch, size, cfg.n_kv_heads, dh)
    if cfg.ssm:
        c["ssm"] = tree_map(
            lambda t: torch.zeros(lead + tuple(t.shape), dtype=t.dtype,
                                  device=device),
            ssm_mod.ssm_init_cache(cfg, batch, dtype, device="meta"))
    return c


def init_cache(cfg, batch: int, max_len: int, dtype, device="cuda"):
    """Decode caches (layout per the comment above) on ``device``."""
    windows = _window_schedule(cfg)
    if uniform_serving(cfg):
        n_scan = cfg.n_layers - cfg.first_dense_layers
        stack = _one_layer_cache(cfg, batch, max_len, int(windows[0]), dtype,
                                 device, lead=(n_scan,))
        dense = [_one_layer_cache(cfg, batch, max_len, int(windows[i]),
                                  dtype, device)
                 for i in range(cfg.first_dense_layers)]
        return {"dense": dense, "stack": stack}
    return [_one_layer_cache(cfg, batch, max_len, int(windows[i]), dtype,
                             device)
            for i in range(cfg.n_layers)]


def _decode_layer(cfg, lp: Params, moe_layer: bool, c: dict, x, pos,
                  window, memory=None, xp=None):
    """One layer of single-token decode; returns (x, cache dict)."""
    c = dict(c)
    h = apply_norm(cfg, x, lp["ln1"])
    if cfg.hybrid_parallel:
        a, c["k"], c["v"] = attn.attention_decode(
            cfg, lp["attn"], h, pos, c["k"], c["v"], window=window)
        m, c["ssm"] = ssm_mod.ssm_decode(cfg, lp["ssm"], h, c["ssm"])
        x = x + 0.5 * (apply_norm(cfg, a, lp["branch_norm_attn"])
                       + apply_norm(cfg, m, lp["branch_norm_ssm"]))
    elif cfg.ssm:
        m, c["ssm"] = ssm_mod.ssm_decode(cfg, lp["ssm"], h, c["ssm"])
        x = x + m
    elif cfg.attn_kind == "mla":
        a, c["c_kv"], c["k_rope"] = mla_mod.mla_decode(
            cfg, lp["attn"], h, pos, c["c_kv"], c["k_rope"],
            absorbed=cfg.mla_absorbed_decode)
        x = x + a
    else:
        a, c["k"], c["v"] = attn.attention_decode(
            cfg, lp["attn"], h, pos, c["k"], c["v"], window=window)
        x = x + a
    if cfg.encoder_decoder and memory is not None and xp is not None:
        x = _cross_attention(cfg, xp, x, pos[:, None], memory)
    x, _ = _ffn(cfg, lp, x, moe_layer)
    return x, c


def _storage_ptr(t: torch.Tensor) -> int:
    return (t.to_local() if is_dtensor(t) else t).data_ptr()


def _store_layer(stack: dict, j: int, c: dict) -> None:
    """Write layer ``j``'s new cache into the stacked cache (in place; the
    attention leaves already are views of it)."""
    def put(dst, src):
        if _storage_ptr(src) != _storage_ptr(dst[j]):
            dst[j].copy_(src)
    tree_map(put, stack, c)


def decode_step(cfg, params: Params, caches, token: torch.Tensor,
                pos: torch.Tensor, memory: torch.Tensor | None = None):
    """token: [B] integer; pos: [B] absolute position. Returns
    (logits [B, paddedV], caches) — the caches updated in place."""
    dtype = torch_dtype(cfg.dtype)
    x = embed(token[:, None], params["embed"], dtype)     # [B,1,D]
    windows = _window_schedule(cfg)
    if uniform_serving(cfg):
        new_dense = []
        for i in range(cfg.first_dense_layers):
            lp, _ = _resolved_layer(cfg, params, i)
            x, c = _decode_layer(cfg, lp, False, caches["dense"][i], x, pos,
                                 int(windows[i]))
            new_dense.append(c)
        w0 = int(windows[cfg.first_dense_layers]) \
            if cfg.first_dense_layers < cfg.n_layers else 0
        stack = caches["stack"]
        for j in range(cfg.n_layers - cfg.first_dense_layers):
            lp = gather_layer_params(cfg, layer_slice(params["layers"], j))
            x, c = _decode_layer(cfg, lp, cfg.moe, layer_slice(stack, j), x,
                                 pos, w0)
            _store_layer(stack, j, c)
        new_caches = {"dense": new_dense, "stack": stack}
    else:
        new_caches = []
        for i in range(cfg.n_layers):
            lp, moe_layer = _resolved_layer(cfg, params, i)
            xp = (layer_slice(params["xattn_layers"], i)
                  if cfg.encoder_decoder else None)
            x, c = _decode_layer(cfg, lp, moe_layer, caches[i], x, pos,
                                 int(windows[i]), memory=memory, xp=xp)
            new_caches.append(c)
    x = apply_norm(cfg, x, params["final_norm"])
    return unembed(x[:, 0], params["embed"]), new_caches


def _prefill_layer(cfg, lp: Params, moe_layer: bool, x, positions, window,
                   max_len: int, memory=None, xp=None):
    """One layer of prefill; returns (x, cache_dict)."""
    b, t = x.shape[0], x.shape[1]
    c = _one_layer_cache(cfg, b, max_len, window, x.dtype, x.device)
    h = apply_norm(cfg, x, lp["ln1"])
    if cfg.hybrid_parallel:
        a, (k, v) = attn.attention_prefill(cfg, lp["attn"], h, positions,
                                           window=window)
        _write_kv(c, k, v, t)
        m = ssm_mod.ssm_forward(cfg, lp["ssm"], h)
        c["ssm"] = _ssm_prefill_cache(cfg, lp["ssm"], h, c["ssm"])
        x = x + 0.5 * (apply_norm(cfg, a, lp["branch_norm_attn"])
                       + apply_norm(cfg, m, lp["branch_norm_ssm"]))
    elif cfg.ssm:
        m = ssm_mod.ssm_forward(cfg, lp["ssm"], h)
        c["ssm"] = _ssm_prefill_cache(cfg, lp["ssm"], h, c["ssm"])
        x = x + m
    elif cfg.attn_kind == "mla":
        a, (ckv, kr) = mla_mod.mla_prefill(cfg, lp["attn"], h, positions)
        c["c_kv"] = _ring_cache(c["c_kv"], ckv, t)
        c["k_rope"] = _ring_cache(c["k_rope"], kr, t)
        x = x + a
    else:
        a, (k, v) = attn.attention_prefill(cfg, lp["attn"], h, positions,
                                           window=window)
        _write_kv(c, k, v, t)
        x = x + a
    if cfg.encoder_decoder and memory is not None and xp is not None:
        x = _cross_attention(cfg, xp, x, positions, memory)
    x, _ = _ffn(cfg, lp, x, moe_layer)
    return x, c


def _stack_trees(trees: list):
    """Per-layer cache trees -> one tree of [L, ...] tensors."""
    return tree_map(lambda *ts: torch.stack(ts), trees[0], *trees[1:])


def prefill(cfg, params: Params, batch: dict, max_len: int):
    """Run the full prompt, build decode caches.

    Returns (last-token logits [B, paddedV], caches, memory|None)."""
    dtype = torch_dtype(cfg.dtype)
    memory = None
    if cfg.encoder_decoder:
        memory = _encoder_stack(cfg, params, batch["frames"].to(dtype))
    x = embed(batch["tokens"], params["embed"], dtype)
    if cfg.frontend == "vision" and "patches" in batch:
        x = torch.cat([batch["patches"].to(dtype), x], dim=1)
    b, t = x.shape[0], x.shape[1]
    sp = cfg.serve_seq_parallel and t % 16 == 0
    if sp:
        # Small-model serving: weights replicated, sequence sharded over
        # the model axis — elementwise/FFN/projection work divides over it
        # with no collective; only attention K/V gather per layer.
        x = maybe_shard(x, ("pod", "data"), "model", None)
    positions = torch.arange(t, device=x.device).expand(b, t)
    windows = _window_schedule(cfg)
    if uniform_serving(cfg):
        dense = []
        for i in range(cfg.first_dense_layers):
            lp, _ = _resolved_layer(cfg, params, i)
            x, c = _prefill_layer(cfg, lp, False, x, positions,
                                  int(windows[i]), max_len)
            dense.append(c)
        w0 = int(windows[cfg.first_dense_layers]) \
            if cfg.first_dense_layers < cfg.n_layers else 0
        per_layer = []
        for j in range(cfg.n_layers - cfg.first_dense_layers):
            lp = gather_layer_params(cfg, layer_slice(params["layers"], j))
            x, c = _prefill_layer(cfg, lp, cfg.moe, x, positions, w0,
                                  max_len)
            per_layer.append(c)
        caches = {"dense": dense, "stack": _stack_trees(per_layer)}
    else:
        caches = []
        for i in range(cfg.n_layers):
            lp, moe_layer = _resolved_layer(cfg, params, i)
            xp = (layer_slice(params["xattn_layers"], i)
                  if cfg.encoder_decoder else None)
            x, c = _prefill_layer(cfg, lp, moe_layer, x, positions,
                                  int(windows[i]), max_len, memory=memory,
                                  xp=xp)
            if sp:  # re-pin SP after gathers (SSM scans etc.)
                x = maybe_shard(x, ("pod", "data"), "model", None)
            caches.append(c)
    x = apply_norm(cfg, x, params["final_norm"])
    return unembed(x[:, -1], params["embed"]), caches, memory


def _ring_cache(buf: torch.Tensor, val: torch.Tensor, t: int
                ) -> torch.Tensor:
    """The ring cache ``buf`` ([B, C, ...], fresh zeros) holding the ``t``
    prefill positions of ``val`` ([B, t, ...]): position ``p`` at slot
    ``p mod C``, the last ``C`` positions when ``t > C``, zeros past
    ``t``. A plain ``val`` is written into ``buf`` in place; a DTensor
    ``val`` gives a new cache built from it, of its own layout."""
    size = buf.shape[1]
    if not is_dtensor(val):
        if size >= t:
            buf[:, :t] = val
        else:
            pos = torch.arange(t - size, t, device=val.device) % size
            buf[:, pos] = val[:, t - size:]
        return buf
    if size == t:
        return val.to(buf.dtype)
    if size > t:
        tail = val.new_zeros((val.shape[0], size - t) + tuple(val.shape[2:]))
        return torch.cat([val, tail], dim=1).to(buf.dtype)
    return torch.roll(val[:, t - size:], (t - size) % size,
                      dims=1).to(buf.dtype)


def _write_kv(c: dict, k: torch.Tensor, v: torch.Tensor, t: int) -> None:
    """Prefill K/V as the (possibly window-sized) ring cache."""
    c["k"] = _ring_cache(c["k"], k, t)
    c["v"] = _ring_cache(c["v"], v, t)


def _ssm_prefill_cache(cfg, lp: dict, h: torch.Tensor, cache: dict) -> dict:
    """The final SSM state + conv window for decode handoff: the state
    the reference's per-token recurrence ends in, from ``cache["state"]``,
    in closed form (``ssm.final_state``)."""
    d_inner, nh = ssm_mod.ssm_dims(cfg)
    n = cfg.ssm_state
    _, xbc, dtraw = ssm_mod._split_proj(cfg, lp, h)
    xbc_conv = ssm_mod._causal_conv(lp, xbc, h.dtype)
    bs, t, _ = h.shape
    xh = xbc_conv[..., :d_inner].reshape(bs, t, nh,
                                         cfg.ssm_head_dim).float()
    b = xbc_conv[..., d_inner:d_inner + n].float()
    dt = ssm_mod.softplus(dtraw.float() + lp["dt_bias"][None, None].float())
    state = ssm_mod.final_state(xh, dt, lp["a_log"], b, cache["state"])
    width = cfg.ssm_conv_width
    # A copy: a view would keep the layer's whole [B, T, ...] input
    # projection alive as long as the cache.
    conv = xbc[:, t - (width - 1):, :].clone() if t >= width - 1 else \
        torch.nn.functional.pad(xbc, (0, 0, width - 1 - t, 0))
    return {"conv": conv, "state": state}
