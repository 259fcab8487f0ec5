"""The port's LM stack (config, configs, models) against the reference.

* **Components.** The 15 properties of ``tests/models/test_components.py``
  (attention causality, decode = prefill, SWA masking, the ring cache,
  MLA absorbed = naive = full, MoE shapes/drops/routing oracle, SSD
  chunked = naive, chunk-size invariance, SSM decode, the chunked
  attention paths) on the port's own draws (``torch.Generator``), with
  the reference's tolerances; and each component held against the
  reference's on the same parameters (carried over leaf for leaf) and
  the same seeded NumPy inputs, float32, within 2e-5.
* **All 10 archs.** With the reference's ``init_params`` carried over by
  ``convert.params_from_reference``: forward logits, ``loss_fn``, the
  prefill logits and three decode steps, in float32 within 1e-5 (the
  smoke logits are O(1); measured at most 1.5e-6: matmul sum order) with
  identical greedy tokens; in bfloat16 within 6e-2 on the logits
  (measured at most 1.4e-2, a few bf16 ulps of O(1) values: the two
  frameworks round products and sums at other places), both decoding the
  reference's tokens.
* **Shapes.** The port's ``init_params`` has the reference's tree, shapes
  and dtypes on every smoke config, and ``count_params`` equals the
  reference's on all 10 full configs (meta tensors: no allocation).
* The smoke properties of ``tests/models/test_archs_smoke.py``
  (forward shapes, prefill + decode finite, prefill = forward's last
  position) on the port's own draws.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import base as rbase
from repro.models import attention as rattn
from repro.models import mla as rmla
from repro.models import model as rmodel
from repro.models import moe as rmoe
from repro.models import ssm as rssm
from repro_torch.config import base as tbase
from repro_torch.convert import params_from_reference
from repro_torch.models import attention as attn
from repro_torch.models import mla as mla_mod
from repro_torch.models import model as tmodel
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.init import Draw
from repro_torch.models.tree import tree_leaves, tree_map

ARCH_IDS = tbase.ARCH_IDS
F32_TOL = 1e-5
BF16_TOL = 6e-2
COMPONENT_TOL = 2e-5
KEY = jax.random.PRNGKey(0)


def _draw(seed=0):
    return Draw(torch.Generator().manual_seed(seed), "cpu")


def _normal(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _carry(ref_params):
    """Reference component params -> port tensors (the same values)."""
    return tree_map(lambda a: _t(np.array(a, np.float32)),
                    jax.tree.map(np.asarray, ref_params))


def _cfg(**kw):
    base = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
                n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
                vocab_pad_multiple=128, remat="none", dtype="float32")
    base.update(kw)
    return tbase.ModelConfig(**base), rbase.ModelConfig(**base)


def _pos(b, t):
    return torch.arange(t).expand(b, t)


# --------------------------------------------------------------------- #
# tests/models/test_components.py through the port
# --------------------------------------------------------------------- #


def test_attention_causal_prefix_property():
    cfg, _ = _cfg()
    p = attn.gqa_params(_draw(), cfg)
    x = _t(_normal(1, (2, 8, 64)))
    full = attn.attention(cfg, p, x, _pos(2, 8))
    x2 = x.clone()
    x2[:, 5:] = 0.0
    part = attn.attention(cfg, p, x2, _pos(2, 8))
    np.testing.assert_allclose(full[:, :5], part[:, :5], rtol=2e-5, atol=2e-5)


def test_decode_matches_prefill():
    cfg, _ = _cfg()
    p = attn.gqa_params(_draw(), cfg)
    b, t = 2, 8
    x = _t(_normal(2, (b, t, 64)))
    full, _ = attn.attention_prefill(cfg, p, x, _pos(b, t))
    ck = torch.zeros((b, t, cfg.n_kv_heads, 16))
    cv = torch.zeros((b, t, cfg.n_kv_heads, 16))
    outs = []
    for i in range(t):
        o, ck, cv = attn.attention_decode(cfg, p, x[:, i:i + 1],
                                          torch.full((b,), i), ck, cv)
        outs.append(o[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1), full, rtol=2e-4,
                               atol=2e-4)


def test_sliding_window_masks_far_tokens():
    cfg, _ = _cfg(sliding_window=4)
    p = attn.gqa_params(_draw(), cfg)
    x = _t(_normal(3, (1, 16, 64)))
    base = attn.attention(cfg, p, x, _pos(1, 16))
    x2 = x.clone()
    x2[:, :8] = 1e3
    pert = attn.attention(cfg, p, x2, _pos(1, 16))
    np.testing.assert_allclose(base[:, 14:], pert[:, 14:], rtol=2e-5,
                               atol=2e-5)


def test_ring_cache_decode_swa():
    cfg, _ = _cfg(sliding_window=4)
    p = attn.gqa_params(_draw(), cfg)
    b, t = 1, 12
    x = _t(_normal(4, (b, t, 64)))
    ck_full = torch.zeros((b, t, cfg.n_kv_heads, 16))
    cv_full = torch.zeros((b, t, cfg.n_kv_heads, 16))
    ck_ring = torch.zeros((b, 4, cfg.n_kv_heads, 16))
    cv_ring = torch.zeros((b, 4, cfg.n_kv_heads, 16))
    for i in range(t):
        of, ck_full, cv_full = attn.attention_decode(
            cfg, p, x[:, i:i + 1], torch.full((b,), i), ck_full, cv_full)
        orr, ck_ring, cv_ring = attn.attention_decode(
            cfg, p, x[:, i:i + 1], torch.full((b,), i), ck_ring, cv_ring)
        np.testing.assert_allclose(of, orr, rtol=2e-4, atol=2e-4)


def _mla_cfg():
    return _cfg(attn_kind="mla", n_heads=4, q_lora_rank=32,
                kv_lora_rank=24, qk_nope_head_dim=16, qk_rope_head_dim=8,
                v_head_dim=16)


def test_mla_decode_absorbed_equals_naive():
    cfg, _ = _mla_cfg()
    p = mla_mod.mla_params(_draw(), cfg)
    b, t = 2, 6
    x = _t(_normal(5, (b, t, 64)))
    cc, ckr = torch.zeros((b, t, 24)), torch.zeros((b, t, 8))
    cc2, ckr2 = cc.clone(), ckr.clone()
    for i in range(t):
        oa, cc, ckr = mla_mod.mla_decode(cfg, p, x[:, i:i + 1],
                                         torch.full((b,), i), cc, ckr,
                                         absorbed=True)
        on, cc2, ckr2 = mla_mod.mla_decode(cfg, p, x[:, i:i + 1],
                                           torch.full((b,), i), cc2, ckr2,
                                           absorbed=False)
        np.testing.assert_allclose(oa, on, rtol=2e-4, atol=2e-4)


def test_mla_decode_matches_full_attention():
    cfg, _ = _mla_cfg()
    p = mla_mod.mla_params(_draw(), cfg)
    b, t = 1, 6
    x = _t(_normal(6, (b, t, 64)))
    full = mla_mod.mla_attention(cfg, p, x, _pos(b, t))
    cc, ckr = torch.zeros((b, t, 24)), torch.zeros((b, t, 8))
    outs = []
    for i in range(t):
        o, cc, ckr = mla_mod.mla_decode(cfg, p, x[:, i:i + 1],
                                        torch.full((b,), i), cc, ckr)
        outs.append(o[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1), full, rtol=2e-4,
                               atol=2e-4)


def _moe_cfg(**kw):
    return _cfg(moe=True, n_experts=8, top_k=2, moe_d_ff=32,
                n_shared_experts=1, d_ff=0, **kw)


def test_moe_shapes_and_aux():
    cfg, _ = _moe_cfg()
    p = moe_mod.moe_params(_draw(), cfg)
    x = _t(_normal(7, (2, 16, 64)))
    y, aux = moe_mod.moe_ffn(cfg, p, x)
    assert y.shape == x.shape
    assert np.isfinite(float(aux["load_balance_loss"]))
    assert float(aux["load_balance_loss"]) >= 0.99


def test_moe_capacity_drops_gracefully():
    cfg, _ = _moe_cfg(capacity_factor=0.1)
    p = moe_mod.moe_params(_draw(), cfg)
    y, _ = moe_mod.moe_ffn(cfg, p, _t(_normal(8, (2, 32, 64))))
    assert bool(torch.isfinite(y).all())


def test_moe_matches_dense_routing_oracle():
    cfg, _ = _moe_cfg(capacity_factor=8.0)
    p = moe_mod.moe_params(_draw(), cfg)
    x = _t(_normal(9, (1, 8, 64)))
    y, _ = moe_mod.moe_ffn(cfg, p, x)
    xf = x.reshape(8, 64)
    probs = torch.softmax(xf @ p["router"], -1)
    tw, te = moe_mod.top_k(probs, cfg.top_k)
    tw = tw / tw.sum(-1, keepdim=True)
    silu = torch.nn.functional.silu
    want = np.zeros((8, 64), np.float32)
    for t in range(8):
        for j in range(cfg.top_k):
            e = int(te[t, j])
            g = silu(xf[t] @ p["w_gate"][e]) * (xf[t] @ p["w_up"][e])
            want[t] += float(tw[t, j]) * (g @ p["w_down"][e]).numpy()
    sp = p["shared"]
    want = want + ((silu(xf @ sp["w_gate"]) * (xf @ sp["w_up"]))
                   @ sp["w_down"]).numpy()
    np.testing.assert_allclose(y[0], want, rtol=2e-4, atol=2e-4)


def _ssm_cfg(chunk=8):
    return _cfg(attn_kind="none", ssm=True, ssm_state=16, ssm_head_dim=16,
                ssm_expand=2, ssm_chunk=chunk, d_ff=0)


def test_ssd_chunked_equals_naive():
    cfg, _ = _ssm_cfg(8)
    p = ssm_mod.ssm_params(_draw(), cfg)
    u = _t(_normal(10, (2, 32, 64), 0.5))
    np.testing.assert_allclose(ssm_mod.ssm_forward(cfg, p, u),
                               ssm_mod.ssm_naive(cfg, p, u),
                               rtol=2e-3, atol=2e-3)


def test_ssd_chunk_size_invariance():
    (cfg8, _), (cfg16, _) = _ssm_cfg(8), _ssm_cfg(16)
    p = ssm_mod.ssm_params(_draw(), cfg8)
    u = _t(_normal(11, (1, 32, 64), 0.5))
    np.testing.assert_allclose(ssm_mod.ssm_forward(cfg8, p, u),
                               ssm_mod.ssm_forward(cfg16, p, u),
                               rtol=2e-3, atol=2e-3)


def test_ssm_decode_matches_forward():
    cfg, _ = _ssm_cfg(8)
    p = ssm_mod.ssm_params(_draw(), cfg)
    b, t = 1, 16
    u = _t(_normal(12, (b, t, 64), 0.5))
    full = ssm_mod.ssm_naive(cfg, p, u)
    cache = ssm_mod.ssm_init_cache(cfg, b, device="cpu")
    outs = []
    for i in range(t):
        y, cache = ssm_mod.ssm_decode(cfg, p, u[:, i:i + 1], cache)
        outs.append(y[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1), full, rtol=2e-3,
                               atol=2e-3)


def test_sdpa_chunked_matches_dense():
    cfg, _ = _cfg()
    p = attn.gqa_params(_draw(), cfg)
    b, t = 2, 64
    x = _t(_normal(20, (b, t, 64)))
    q, k, v = attn._project_qkv(cfg, p, x, _pos(b, t))
    dense = attn._sdpa_dense(q, k, v, attn._mask(t, t, True, 0))
    chunk = attn._sdpa_chunked(q, k, v, causal=True, window=0, kv_block=16)
    np.testing.assert_allclose(chunk, dense, rtol=2e-4, atol=2e-4)


def test_sdpa_chunked_with_window():
    cfg, _ = _cfg()
    p = attn.gqa_params(_draw(), cfg)
    b, t = 1, 48
    x = _t(_normal(21, (b, t, 64)))
    q, k, v = attn._project_qkv(cfg, p, x, _pos(b, t))
    dense = attn._sdpa_dense(q, k, v, attn._mask(t, t, True, 8))
    chunk = attn._sdpa_chunked(q, k, v, causal=True, window=8, kv_block=16)
    np.testing.assert_allclose(chunk, dense, rtol=2e-4, atol=2e-4)


def test_mla_chunked_matches_dense():
    cfg, _ = _mla_cfg()
    p = mla_mod.mla_params(_draw(), cfg)
    x = _t(_normal(22, (1, 32, 64)))
    pos = _pos(1, 32)
    dense = mla_mod.mla_attention(cfg, p, x, pos, chunked=False)
    q_nope, q_rope = mla_mod._q_proj(cfg, p, x, pos)
    c_kv, k_rope = mla_mod._kv_latent(cfg, p, x, pos)
    out = mla_mod._mla_chunked(cfg, p, q_nope, q_rope, c_kv, k_rope,
                               kv_block=8)
    chunk = torch.einsum("bthk,hkd->btd", out, p["wo"])
    np.testing.assert_allclose(chunk, dense, rtol=2e-4, atol=2e-4)


# --------------------------------------------------------------------- #
# Components against the reference on the same parameters
# --------------------------------------------------------------------- #


def _close(got, want, tol=COMPONENT_TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("window", [0, 4])
def test_attention_paths_match_reference(window):
    cfg, rcfg = _cfg(sliding_window=window, qkv_bias=True, qk_norm=True)
    rp = rattn.gqa_params(KEY, rcfg)
    rp = {**rp, "bq": rp["bq"] + 0.1, "bk": rp["bk"] - 0.1}
    p = _carry(rp)
    b, t = 2, 40
    x = _normal(30, (b, t, 64))
    rpos = jnp.broadcast_to(jnp.arange(t), (b, t))
    _close(attn.attention(cfg, p, _t(x), _pos(b, t)),
           rattn.attention(rcfg, rp, jnp.asarray(x), rpos))
    q, k, v = attn._project_qkv(cfg, p, _t(x), _pos(b, t))
    rq, rk, rv = rattn._project_qkv(rcfg, rp, jnp.asarray(x), rpos)
    _close(attn._sdpa_chunked(q, k, v, True, window, kv_block=16),
           rattn._sdpa_chunked(rq, rk, rv, True, window, kv_block=16))
    size = t if window == 0 else window
    ck = torch.zeros((b, size, 2, 16))
    cv = torch.zeros((b, size, 2, 16))
    rck, rcv = jnp.zeros((b, size, 2, 16)), jnp.zeros((b, size, 2, 16))
    for i in range(6):
        o, ck, cv = attn.attention_decode(cfg, p, _t(x[:, i:i + 1]),
                                          torch.full((b,), i), ck, cv)
        ro, rck, rcv = rattn.attention_decode(
            rcfg, rp, jnp.asarray(x[:, i:i + 1]), jnp.full((b,), i), rck,
            rcv)
        _close(o, ro)
        _close(ck, rck)


def test_mla_paths_match_reference():
    cfg, rcfg = _mla_cfg()
    rp = rmla.mla_params(KEY, rcfg)
    p = _carry(rp)
    b, t = 2, 24
    x = _normal(31, (b, t, 64))
    rpos = jnp.broadcast_to(jnp.arange(t), (b, t))
    _close(mla_mod.mla_attention(cfg, p, _t(x), _pos(b, t)),
           rmla.mla_attention(rcfg, rp, jnp.asarray(x), rpos))
    _close(mla_mod.mla_attention(cfg, p, _t(x), _pos(b, t), chunked=True),
           rmla.mla_attention(rcfg, rp, jnp.asarray(x), rpos, chunked=True))
    for absorbed in (True, False):
        cc, ckr = torch.zeros((b, t, 24)), torch.zeros((b, t, 8))
        rcc, rckr = jnp.zeros((b, t, 24)), jnp.zeros((b, t, 8))
        for i in range(5):
            o, cc, ckr = mla_mod.mla_decode(cfg, p, _t(x[:, i:i + 1]),
                                            torch.full((b,), i), cc, ckr,
                                            absorbed=absorbed)
            ro, rcc, rckr = rmla.mla_decode(
                rcfg, rp, jnp.asarray(x[:, i:i + 1]), jnp.full((b,), i),
                rcc, rckr, absorbed=absorbed)
            _close(o, ro)


@pytest.mark.parametrize("capacity_factor", [0.1, 1.25, 8.0])
def test_moe_matches_reference(capacity_factor):
    cfg, rcfg = _moe_cfg(capacity_factor=capacity_factor)
    rp = rmoe.moe_params(KEY, rcfg)
    p = _carry(rp)
    x = _normal(32, (2, 16, 64))
    y, aux = moe_mod.moe_ffn(cfg, p, _t(x))
    ry, raux = rmoe.moe_ffn(rcfg, rp, jnp.asarray(x))
    _close(y, ry)
    for k in ("load_balance_loss", "z_loss"):
        _close(aux[k], raux[k])


def test_moe_top_k_ties_keep_index_order():
    probs = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1]],
                     np.float32)
    rw, re = jax.lax.top_k(jnp.asarray(probs), 2)
    tw, te = moe_mod.top_k(_t(probs), 2)
    np.testing.assert_array_equal(te.numpy(), np.asarray(re))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(rw))


def test_ssm_paths_match_reference():
    cfg, rcfg = _ssm_cfg(8)
    rp = rssm.ssm_params(KEY, rcfg)
    rp = {**rp, "a_log": rp["a_log"] + 0.3, "conv_b": rp["conv_b"] + 0.05}
    p = _carry(rp)
    u = _normal(33, (2, 32, 64), 0.5)
    _close(ssm_mod.ssm_forward(cfg, p, _t(u)),
           rssm.ssm_forward(rcfg, rp, jnp.asarray(u)))
    _close(ssm_mod.ssm_naive(cfg, p, _t(u)),
           rssm.ssm_naive(rcfg, rp, jnp.asarray(u)))
    cache = ssm_mod.ssm_init_cache(cfg, 2, device="cpu")
    rcache = rssm.ssm_init_cache(rcfg, 2)
    for i in range(4):
        y, cache = ssm_mod.ssm_decode(cfg, p, _t(u[:, i:i + 1]), cache)
        ry, rcache = rssm.ssm_decode(rcfg, rp, jnp.asarray(u[:, i:i + 1]),
                                     rcache)
        _close(y, ry)
        _close(cache["state"], rcache["state"])


# --------------------------------------------------------------------- #
# Configs, shapes, counts
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_equal_reference_field_for_field(arch):
    for get in ("get_config", "get_smoke_config"):
        t = dataclasses.asdict(getattr(tbase, get)(arch))
        r = dataclasses.asdict(getattr(rbase, get)(arch))
        assert t == r
    assert list(tbase.shapes_for(arch)) == list(rbase.shapes_for(arch))
    assert dataclasses.asdict(tbase.TrainConfig()) \
        == dataclasses.asdict(rbase.TrainConfig())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_count_params_equals_reference(arch):
    cfg, rcfg = tbase.get_config(arch), rbase.get_config(arch)
    assert cfg.param_count() == rcfg.param_count()
    assert cfg.active_param_count() == rcfg.active_param_count()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_params_tree_shapes_dtypes_equal_reference(arch):
    cfg = tbase.get_smoke_config(arch)
    ref = jax.eval_shape(lambda: rmodel.init_params(
        rbase.get_smoke_config(arch), KEY))
    port = tmodel.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    paths = []
    jax.tree_util.tree_map_with_path(
        lambda p, leaf: paths.append(
            ("/".join(str(getattr(k, "key", k)) for k in p),
             tuple(leaf.shape), str(leaf.dtype))), ref)

    def walk(tree, path=""):
        if isinstance(tree, dict):
            return [r for k in sorted(tree)
                    for r in walk(tree[k], f"{path}/{k}" if path else k)]
        return [(path, tuple(tree.shape), str(tree.dtype).split(".")[-1])]

    assert sorted(walk(port)) == sorted(paths)
    assert all(torch.isfinite(t).all() for t in tree_leaves(port))


def test_params_from_reference_maps_leaf_for_leaf():
    cfg = tbase.get_smoke_config("deepseek-v2-236b")
    rp = jax.tree.map(np.asarray, rmodel.init_params(
        rbase.get_smoke_config("deepseek-v2-236b"), KEY))
    tp = params_from_reference(cfg, rp, device="cpu")
    np.testing.assert_array_equal(tp["layers"]["moe"]["w_gate"].numpy(),
                                  rp["layers"]["moe"]["w_gate"])
    np.testing.assert_array_equal(tp["dense_layer_0"]["mlp"]["w_up"].numpy(),
                                  rp["dense_layer_0"]["mlp"]["w_up"])
    bad = dict(rp)
    bad.pop("final_norm")
    with pytest.raises(ValueError, match="do not match"):
        params_from_reference(cfg, bad, device="cpu")


# --------------------------------------------------------------------- #
# All 10 archs: forward, loss, prefill, decode against the reference
# --------------------------------------------------------------------- #

B, S = 2, 16


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S + 1),
                                    dtype=np.int32)}
    if cfg.encoder_decoder:
        batch["frames"] = _normal(seed + 1, (B, S, cfg.d_model), 0.02)
    if cfg.frontend == "vision":
        batch["patches"] = _normal(seed + 2, (B, cfg.n_frontend_tokens,
                                              cfg.d_model), 0.02)
    return batch


def _as_port(batch):
    return {k: _t(v.astype(np.int64) if k == "tokens" else v)
            for k, v in batch.items()}


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _against_reference(arch, dtype):
    rcfg = dataclasses.replace(rbase.get_smoke_config(arch), dtype=dtype)
    cfg = dataclasses.replace(tbase.get_smoke_config(arch), dtype=dtype)
    rp = rmodel.init_params(rcfg, KEY)
    tp = params_from_reference(cfg, jax.tree.map(np.asarray, rp),
                               device="cpu")
    batch = _batch(cfg)
    prompt = {k: (v[:, :S] if k == "tokens" else v)
              for k, v in batch.items()}
    rb = {k: jnp.asarray(v) for k, v in prompt.items()}
    errs = {}
    rlog, _ = jax.jit(lambda p, b: rmodel.forward(rcfg, p, b))(rp, rb)
    tlog, _ = tmodel.forward(cfg, tp, _as_port(prompt))
    errs["forward"] = np.abs(_f32(tlog) - _f32(rlog)).max()
    rloss, _ = jax.jit(lambda p, b: rmodel.loss_fn(rcfg, p, b))(
        rp, {k: jnp.asarray(v) for k, v in batch.items()})
    tloss, _ = tmodel.loss_fn(cfg, tp, _as_port(batch))
    errs["loss"] = abs(float(tloss) - float(rloss))
    extra = cfg.n_frontend_tokens if cfg.frontend == "vision" else 0
    max_len = S + 4 + extra
    rlog, rc, rmem = jax.jit(
        lambda p, b: rmodel.prefill(rcfg, p, b, max_len))(rp, rb)
    tlog, tc, tmem = tmodel.prefill(cfg, tp, _as_port(prompt), max_len)
    errs["prefill"] = np.abs(_f32(tlog) - _f32(rlog)).max()
    same = []
    rdec = jax.jit(lambda p, c, t, q: rmodel.decode_step(rcfg, p, c, t, q,
                                                         memory=rmem))
    for i in range(3):
        rtok = np.asarray(jnp.argmax(rlog[:, :cfg.vocab_size], -1))
        ttok = tlog[:, :cfg.vocab_size].argmax(-1).numpy()
        same.append(bool((rtok == ttok).all()))
        pos = np.full(B, S + extra + i, np.int32)
        rlog, rc = rdec(rp, rc, jnp.asarray(rtok), jnp.asarray(pos))
        tlog, tc = tmodel.decode_step(cfg, tp, tc, _t(rtok.astype(np.int64)),
                                      _t(pos.astype(np.int64)), memory=tmem)
        errs[f"decode{i}"] = np.abs(_f32(tlog) - _f32(rlog)).max()
    return errs, same


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_float32_parity_with_reference(arch):
    errs, same = _against_reference(arch, "float32")
    assert max(errs.values()) < F32_TOL, errs
    assert all(same), same


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_bfloat16_parity_with_reference(arch):
    errs, _ = _against_reference(arch, "bfloat16")
    assert max(errs.values()) < BF16_TOL, errs


# --------------------------------------------------------------------- #
# tests/models/test_archs_smoke.py on the port's own draws
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_forward_prefill_decode(arch):
    cfg = tbase.get_smoke_config(arch)
    params = tmodel.init_params(cfg, 0, device="cpu")
    batch = _as_port(_batch(cfg))
    inner = dict(batch)
    inner["tokens"] = batch["tokens"][:, :-1]
    logits, aux = tmodel.forward(cfg, params, inner)
    extra = cfg.n_frontend_tokens if cfg.frontend == "vision" else 0
    assert logits.shape == (B, S + extra, cfg.padded_vocab)
    assert logits.dtype == torch.bfloat16
    assert bool(torch.isfinite(logits).all())
    loss, _ = tmodel.loss_fn(cfg, params, batch)
    assert bool(torch.isfinite(loss))
    logits, caches, memory = tmodel.prefill(cfg, params, inner, S + 4 + extra)
    assert logits.shape == (B, cfg.padded_vocab)
    tok = logits[:, :cfg.vocab_size].argmax(-1)
    for i in range(2):
        logits, caches = tmodel.decode_step(
            cfg, params, caches, tok, torch.full((B,), S + extra + i),
            memory=memory)
        assert bool(torch.isfinite(logits).all())
        tok = logits[:, :cfg.vocab_size].argmax(-1)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mamba2-130m",
                                  "qwen3-1.7b"])
def test_decode_consistent_with_forward(arch):
    cfg = tbase.get_smoke_config(arch)
    params = tmodel.init_params(cfg, 0, device="cpu")
    tokens = _t(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (1, S)).astype(np.int64))
    want, _ = tmodel.forward(cfg, params, {"tokens": tokens})
    got, _, _ = tmodel.prefill(cfg, params, {"tokens": tokens}, S + 4)
    np.testing.assert_allclose(_f32(got), _f32(want[:, -1]), rtol=3e-2,
                               atol=3e-2)


def test_init_params_is_reproducible_from_the_generator():
    cfg = tbase.get_smoke_config("qwen1.5-0.5b")
    a = tmodel.init_params(cfg, torch.Generator().manual_seed(5),
                           device="cpu")
    b = tmodel.init_params(cfg, 5, device="cpu")
    c = tmodel.init_params(cfg, 6, device="cpu")
    la, lb, lc = (tree_leaves(t) for t in (a, b, c))
    assert all(torch.equal(x, y) for x, y in zip(la, lb))
    assert not torch.equal(la[0], lc[0])
