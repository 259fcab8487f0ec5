"""The VLM and MLA families (llava-next-mistral-7b, deepseek-v2-236b).

* A MoE config cut to its dense layers (``n_layers ==
  first_dense_layers``; deepseek-v2-236b's and moonshot-v1-16b-a3b's
  smoke configs at 1 layer, float32): ``prefill`` gives a ``stack``
  whose leaves have length 0, as the reference's ``lax.scan`` over the
  empty stack and ``init_cache`` do; every cache shape equals the
  reference's; prefill and 4 greedy decode steps within 1e-5 of the
  reference's logits with equal tokens; ``ServeEngine`` on deepseek's
  config gives the reference's token streams.
* llava-next-mistral-7b with its real 2,880-patch prefix, at 2 layers
  and d 128: prefill and 4 greedy decode steps against the reference in
  float32 within 1e-5, tokens equal.
* deepseek-v2-236b with its real routing (160 experts, top-6, 2 shared,
  the first layer dense) and MLA's rank ratios at 3 layers and narrow
  widths: prefill and 4 greedy decode steps against the reference, the
  decode absorbed and naive, within 1e-5 with equal tokens; at every
  router call the expert ids the reference's ``lax.top_k`` chose equal
  the port's, and the port's capacity-drop mask equals the reference's
  rule applied to them.
* ``mla._mla_chunked`` tiled over queries against the untiled call
  (within 1e-6) and the reference's (within 1e-5).
* ``chip_smoke.lm_vlm_mla`` (phase 26) rehearses on the CPU at the
  smoke configs.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import base as rbase
from repro.models import mla as rmla
from repro.models import model as rmodel
from repro.serve.engine import Request as RRequest
from repro.serve.engine import ServeEngine as RServeEngine
from repro_torch.config import base as tbase
from repro_torch.convert import params_from_reference
from repro_torch.models import mla as mla_mod
from repro_torch.models import model as tmodel
from repro_torch.models import moe as moe_mod
from repro_torch.models.tree import tree_leaves, tree_map
from repro_torch.serve.engine import Request, ServeEngine

import repro.pum  # noqa: F401  (registers the reference's backends)
import repro_torch.pum  # noqa: F401  (registers the port's backends)

ROOT = pathlib.Path(__file__).resolve().parents[1]
KEY = jax.random.PRNGKey(0)
F32_TOL = 1e-5       # logits, as tests/test_torch_lm.py
TILE_TOL = 1e-6      # the tiled MLA prefill against the untiled one
TOKENS, STEPS = 16, 4


def _pair(arch: str, smoke: bool, **kw):
    """The port's and the reference's config of ``arch`` with ``kw``,
    float32."""
    get_t = tbase.get_smoke_config if smoke else tbase.get_config
    get_r = rbase.get_smoke_config if smoke else rbase.get_config
    kw = dict(kw, dtype="float32")
    return (dataclasses.replace(get_t(arch), **kw),
            dataclasses.replace(get_r(arch), **kw))


def _params(cfg, rcfg):
    rp = rmodel.init_params(rcfg, KEY)
    return rp, params_from_reference(cfg, jax.tree.map(np.asarray, rp),
                                     device="cpu")


def _prompt(cfg, n_patches: int = 0) -> dict:
    rng = np.random.default_rng(3)
    prompt = {"tokens": rng.integers(0, cfg.vocab_size, (2, TOKENS),
                                     dtype=np.int32)}
    if n_patches:
        prompt["patches"] = (rng.standard_normal(
            (2, n_patches, cfg.d_model)) * 0.02).astype(np.float32)
    return prompt


def _torch_batch(prompt: dict) -> dict:
    return {k: torch.from_numpy(v.astype(np.int64) if k == "tokens" else v)
            for k, v in prompt.items()}


def _run_both(cfg, rcfg, rp, tp, prompt: dict):
    """Prefill and ``STEPS`` greedy decode steps of both packages on the
    same parameters and prompt: the per-stage max abs logit errors, and
    the reference's and the port's caches after the prefill."""
    t = TOKENS + (prompt["patches"].shape[1] if "patches" in prompt else 0)
    max_len = t + STEPS
    rpre = jax.jit(lambda p, b: rmodel.prefill(rcfg, p, b, max_len))
    rdec = jax.jit(lambda p, c, tk, q: rmodel.decode_step(rcfg, p, c, tk, q))
    rlog, rc, _ = rpre(rp, {k: jnp.asarray(v) for k, v in prompt.items()})
    tlog, tc, _ = tmodel.prefill(cfg, tp, _torch_batch(prompt), max_len)
    caches = (rc, tc)
    errs = [np.abs(tlog.numpy() - np.asarray(rlog)).max()]
    for i in range(STEPS):
        rtok = np.asarray(jnp.argmax(rlog[:, :cfg.vocab_size], -1))
        ttok = tlog[:, :cfg.vocab_size].argmax(-1).numpy()
        np.testing.assert_array_equal(ttok, rtok)
        pos = np.full(2, t + i, np.int32)
        rlog, rc = rdec(rp, rc, jnp.asarray(rtok), jnp.asarray(pos))
        tlog, tc = tmodel.decode_step(
            cfg, tp, tc, torch.from_numpy(ttok.astype(np.int64)),
            torch.from_numpy(pos.astype(np.int64)))
        errs.append(np.abs(tlog.numpy() - np.asarray(rlog)).max())
    return errs, caches


# --------------------------------------------------------------------- #
# F10: a MoE config cut to its dense layers
# --------------------------------------------------------------------- #

DENSE_ONLY = ("deepseek-v2-236b", "moonshot-v1-16b-a3b")


@pytest.mark.parametrize("arch", DENSE_ONLY)
def test_dense_only_moe_prefill_and_decode_match_reference(arch):
    cfg, rcfg = _pair(arch, True, n_layers=1)
    assert cfg.n_layers == cfg.first_dense_layers == 1 and cfg.moe
    rp, tp = _params(cfg, rcfg)
    assert all(x.shape[0] == 0 for x in tree_leaves(tp["layers"]))
    errs, (rc, tc) = _run_both(cfg, rcfg, rp, tp, _prompt(cfg))
    assert max(errs) < F32_TOL, errs
    want = jax.tree.map(lambda a: tuple(a.shape), rc)
    got = {"dense": [{k: tuple(v.shape) for k, v in c.items()}
                     for c in tc["dense"]],
           "stack": {k: tuple(v.shape) for k, v in tc["stack"].items()}}
    assert got == want
    assert all(s[0] == 0 for s in got["stack"].values())
    fresh = tmodel.init_cache(cfg, 2, TOKENS + STEPS, torch.float32,
                              device="cpu")
    assert {k: tuple(v.shape) for k, v in fresh["stack"].items()} \
        == got["stack"]


def test_dense_only_moe_serves_the_reference_streams():
    cfg, rcfg = _pair("deepseek-v2-236b", True, n_layers=1)
    rp, tp = _params(cfg, rcfg)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, 8, dtype=np.int32)
               for _ in range(3)]
    ref = RServeEngine(rcfg, params=rp, max_batch=2, max_len=32, eos_id=-1)
    port = ServeEngine(cfg, params=tp, max_batch=2, max_len=32, eos_id=-1,
                       device="cpu")
    try:
        for rid, p in enumerate(prompts):
            ref.submit(RRequest(rid=rid, prompt=p, max_new_tokens=4))
            port.submit(Request(rid=rid, prompt=p, max_new_tokens=4))
        want = sorted((r.rid, list(r.out_tokens))
                      for r in ref.run_until_drained())
        got = sorted((r.rid, list(r.out_tokens))
                     for r in port.run_until_drained())
    finally:
        port.close()
    assert got == want and all(len(s) == 4 for _, s in got)


# --------------------------------------------------------------------- #
# llava with its real patch prefix, deepseek with its real routing
# --------------------------------------------------------------------- #

LLAVA_NARROW = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                    head_dim=32, d_ff=256, vocab_size=512,
                    vocab_pad_multiple=128, remat="none")
# deepseek-v2-236b's ratios at d 320: q_lora 0.3 d, kv_lora 0.1 d, the
# nope head twice the rope head, v as nope.
DEEPSEEK_NARROW = dict(n_layers=3, d_model=320, n_heads=4, n_kv_heads=4,
                       q_lora_rank=96, kv_lora_rank=32, qk_nope_head_dim=32,
                       qk_rope_head_dim=16, v_head_dim=32, d_ff=256,
                       moe_d_ff=32, vocab_size=512, vocab_pad_multiple=128,
                       remat="none")


def test_llava_real_patch_prefix_matches_reference():
    cfg, rcfg = _pair("llava-next-mistral-7b", False, **LLAVA_NARROW)
    assert cfg.n_frontend_tokens == 2880 and cfg.frontend == "vision"
    rp, tp = _params(cfg, rcfg)
    errs, (rc, tc) = _run_both(cfg, rcfg, rp, tp,
                               _prompt(cfg, cfg.n_frontend_tokens))
    assert max(errs) < F32_TOL, errs
    assert tuple(tc["stack"]["k"].shape) == tuple(rc["stack"]["k"].shape) \
        == (2, 2, 2880 + TOKENS + STEPS, 2, 32)


def _reference_drops(top_e: np.ndarray, cap: int) -> np.ndarray:
    """The reference's capacity rule on its own choices: an entry keeps
    a slot when fewer than ``cap`` entries of its expert precede it in
    flat (token, choice) order."""
    flat = top_e.reshape(-1)
    seen: dict[int, int] = {}
    keep = np.zeros(flat.size, bool)
    for i, e in enumerate(flat):
        keep[i] = seen.get(int(e), 0) < cap
        seen[int(e)] = seen.get(int(e), 0) + 1
    return keep


@pytest.mark.parametrize("absorbed", [True, False])
def test_deepseek_real_routing_matches_reference(absorbed, monkeypatch):
    cfg, rcfg = _pair("deepseek-v2-236b", False,
                      mla_absorbed_decode=absorbed, **DEEPSEEK_NARROW)
    assert (cfg.n_experts, cfg.top_k, cfg.n_shared_experts,
            cfg.first_dense_layers) == (160, 6, 2, 1)
    rp, tp = _params(cfg, rcfg)
    chosen = {"ref": [], "port": []}
    real_top_k = jax.lax.top_k
    port_top_k = moe_mod.top_k

    def ref_tap(probs, k):   # under the reference's jit and scan
        out = real_top_k(probs, k)
        jax.debug.callback(lambda e: chosen["ref"].append(np.asarray(e)),
                           out[1], ordered=True)
        return out

    def port_tap(probs, k):
        out = port_top_k(probs, k)
        chosen["port"].append(out[1])
        return out

    monkeypatch.setattr(jax.lax, "top_k", ref_tap)
    monkeypatch.setattr(moe_mod, "top_k", port_tap)
    errs, _ = _run_both(cfg, rcfg, rp, tp, _prompt(cfg))
    assert max(errs) < F32_TOL, errs
    # 2 MoE layers at the prefill and at each decode step
    assert len(chosen["ref"]) == len(chosen["port"]) == 2 * (1 + STEPS)
    dropped = 0
    for want, got in zip(chosen["ref"], chosen["port"]):
        np.testing.assert_array_equal(got.numpy(), want)
        cap = moe_mod.capacity(cfg, want.shape[0])
        _, ok = moe_mod.dispatch(got.reshape(-1), cfg.n_experts, cap)
        np.testing.assert_array_equal(ok.numpy(),
                                      _reference_drops(want, cap))
        dropped += int((~ok).sum())
    assert dropped > 0   # capacity binds at the prefill's 32 tokens


# --------------------------------------------------------------------- #
# MLA's chunked prefill, tiled over queries
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("q_tile", [7, 16, 33])
def test_mla_chunked_query_tiles_match_untiled_and_reference(q_tile):
    cfg, rcfg = _pair("deepseek-v2-236b", False, **DEEPSEEK_NARROW)
    b, t, kv_block = 2, 40, 8
    rng = np.random.default_rng(11)
    rp = jax.tree.map(np.asarray, rmla.mla_params(KEY, rcfg))
    tp = tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)), rp)
    x = (rng.standard_normal((b, t, cfg.d_model)) * 0.5).astype(np.float32)
    pos = np.broadcast_to(np.arange(t), (b, t))
    tx, tpos = torch.from_numpy(x), torch.from_numpy(pos.copy())
    q_nope, q_rope = mla_mod._q_proj(cfg, tp, tx, tpos)
    c_kv, k_rope = mla_mod._kv_latent(cfg, tp, tx, tpos)
    tiled = mla_mod._mla_chunked(cfg, tp, q_nope, q_rope, c_kv, k_rope,
                                 kv_block=kv_block, q_tile=q_tile)
    whole = mla_mod._mla_chunked(cfg, tp, q_nope, q_rope, c_kv, k_rope,
                                 kv_block=kv_block, q_tile=t)
    rq_nope, rq_rope = rmla._q_proj(rcfg, rp, jnp.asarray(x),
                                    jnp.asarray(pos))
    rc_kv, rk_rope = rmla._kv_latent(rcfg, rp, jnp.asarray(x),
                                     jnp.asarray(pos))
    want = rmla._mla_chunked(rcfg, rp, rq_nope, rq_rope, rc_kv, rk_rope,
                             kv_block=kv_block)
    assert tuple(tiled.shape) == (b, t, cfg.n_heads, cfg.v_head_dim)
    np.testing.assert_allclose(tiled.numpy(), whole.numpy(), rtol=0,
                               atol=TILE_TOL)
    np.testing.assert_allclose(tiled.numpy(), np.asarray(want), rtol=0,
                               atol=F32_TOL)


# --------------------------------------------------------------------- #
# Phase 26 of chip_smoke.py, rehearsed on the CPU
# --------------------------------------------------------------------- #


def test_chip_smoke_phase_26_rehearses_on_the_cpu():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from repro_torch.kernels import _build
    out = cs.lm_vlm_mla("cpu", _build, cs.SEED)
    for arch in (cs.VLM_ARCH, cs.MLA_ARCH):
        cells = out[arch]["cells"]
        assert sorted(k for k in cells if not k.endswith("_profile")) == \
            ["decode_32k", "prefill_32k", "train_4k"]
        assert out[arch]["f32_err"] <= cs.SERVE_F32_TOL
    assert out[cs.MLA_ARCH]["cells"]["train_4k"]["layers"] == 1
    assert out[cs.VLM_ARCH]["prefix"]["streams_equal"]
    assert set(out["launches"]) == {"bit_transpose32", "run_program_cuda"}
