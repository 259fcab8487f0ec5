"""The MoE and encoder-decoder families, and the port's kept divergences.

* ``init_params(..., dtype=torch.bfloat16)`` on all 10 smoke configs:
  the tree, shapes and dtypes of ``params_specs(cfg, "bfloat16")``, the
  count of ``count_params``, the same tree from the same seed, each
  normal leaf at its float32 draw's scale (std within 10%); the default
  float32 draw is unchanged (its sum and sum of squares pinned to the
  values the tree before the keyword drew, relative 1e-12).
* ``moe_ffn`` at moonshot-v1-16b-a3b's routing numbers (64 experts,
  top-6, 2 shared, capacity factor 1.25) at a narrow width against the
  reference's on the same parameters, at 1, 2, 4, 32 and 512 tokens:
  the output within 2e-5 and the aux losses within 1e-6 relative
  (float32; the z-loss of O(20) differs in its last bits), the
  expert ids the reference's ``lax.top_k`` chose identical, and the
  capacity-drop mask identical to the reference's rule applied to them
  (rank within the expert in flat order below the capacity).
* moonshot-v1-16b-a3b cut to 4 layers (the dense layer and 3 MoE
  layers) and seamless-m4t-large-v2 (48 frames against 16 tokens: a
  memory longer than the query), both at a narrow width: prefill and 4
  greedy decode steps against the reference in float32 within 1e-5 (as
  ``tests/test_torch_lm.py``), the greedy tokens equal.
* Reference behaviour the port keeps: both packages' ``ServeEngine``
  raise ``KeyError('frames')`` on seamless's smoke config (it passes
  ``prefill`` the tokens only).
* ``select_backend`` requires ``device`` in the port (a kept divergence):
  a reference-style call raises ``TypeError``; with ``device="cpu"`` it
  makes the reference's choice (under the port's names) for the same
  ``require`` and ``width``; ``tools/check_api_torch.py`` lists the
  keyword and reports its loss as drift.
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

from repro.backends import select_backend as ref_select_backend
from repro.config import base as rbase
from repro.models import model as rmodel
from repro.models import moe as rmoe
from repro.serve.engine import Request as RRequest
from repro.serve.engine import ServeEngine as RServeEngine
from repro_torch.backends import select_backend
from repro_torch.config import base as tbase
from repro_torch.convert import params_from_reference
from repro_torch.launch.steps import params_specs
from repro_torch.models import model as tmodel
from repro_torch.models import moe as moe_mod
from repro_torch.models.tree import tree_leaves, tree_map
from repro_torch.serve.engine import Request, ServeEngine

import repro.pum  # noqa: F401  (registers the reference's backends)
import repro_torch.pum  # noqa: F401  (registers the port's backends)

ROOT = pathlib.Path(__file__).resolve().parents[1]
KEY = jax.random.PRNGKey(0)
F32_TOL = 1e-5       # logits, as tests/test_torch_lm.py
MOE_TOL = 2e-5       # moe_ffn's output, float32 (components' tolerance)
AUX_TOL = 1e-6       # the aux losses, relative (float32 scalars up to ~20)

# (sum, sum of squares) of every leaf of init_params(smoke, 0, "cpu"),
# float32 masters, drawn before init_params took a dtype.
F32_DRAW = {
    "hymba-1.5b": (1577.5652956526746, 5225.284753605931),
    "qwen1.5-0.5b": (559.0776722583387, 2998.174679632154),
    "qwen3-1.7b": (688.8935111792175, 2868.000033222328),
    "qwen2.5-32b": (560.8935111792175, 2740.000033222328),
    "phi3-medium-14b": (560.8935111792175, 2740.000033222328),
    "seamless-m4t-large-v2": (1424.4981377050253, 7216.860163328787),
    "llava-next-mistral-7b": (560.8935111792175, 2740.000033222328),
    "moonshot-v1-16b-a3b": (426.6029629825251, 3906.2548810386734),
    "deepseek-v2-236b": (759.580361640978, 5217.954534723742),
    "mamba2-130m": (820.608022744497, 2387.5471682642415),
}


def _paths(tree, path=""):
    if isinstance(tree, dict):
        return [r for k in sorted(tree)
                for r in _paths(tree[k], f"{path}/{k}")]
    return [(path, tuple(tree.shape), tree.dtype)]


def _pairs(a, b):
    """The leaves of two trees of one structure, paired by path."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        return [p for k in sorted(a) for p in _pairs(a[k], b[k])]
    return [(a, b)]


# --------------------------------------------------------------------- #
# init_params in a serving dtype
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", tbase.ARCH_IDS)
def test_init_params_in_bfloat16_has_the_serving_specs(arch):
    cfg = tbase.get_smoke_config(arch)
    got = tmodel.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu", dtype=torch.bfloat16)
    assert _paths(got) == _paths(params_specs(cfg, "bfloat16"))
    assert all(x.dtype == torch.bfloat16 for x in tree_leaves(got))
    assert sum(x.numel() for x in tree_leaves(got)) == cfg.param_count()
    again = tmodel.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu", dtype=torch.bfloat16)
    assert all(torch.equal(x, y) for x, y in _pairs(got, again))
    f32 = tmodel.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    for x, y in _pairs(got, f32):
        if y.numel() >= 256 and float(y.std()) > 0:   # a normal draw
            assert abs(float(x.float().std()) / float(y.std()) - 1) < 0.1
        elif float(y.std()) == 0:                     # ones, zeros, fills
            assert torch.equal(x.float(), y)


@pytest.mark.parametrize("arch", tbase.ARCH_IDS)
def test_init_params_float32_default_draw_is_unchanged(arch):
    p = tmodel.init_params(tbase.get_smoke_config(arch), 0, device="cpu")
    leaves = tree_leaves(p)
    assert all(x.dtype == torch.float32 for x in leaves)
    got = (sum(float(x.double().sum()) for x in leaves),
           sum(float(x.double().square().sum()) for x in leaves))
    np.testing.assert_allclose(got, F32_DRAW[arch], rtol=1e-12)


def test_init_params_on_meta_in_bfloat16_allocates_nothing():
    cfg = tbase.get_config("moonshot-v1-16b-a3b")
    p = tmodel.init_params(cfg, device="meta", dtype=torch.bfloat16)
    assert all(x.is_meta and x.dtype == torch.bfloat16
               for x in tree_leaves(p))
    assert sum(x.numel() for x in tree_leaves(p)) == 28_317_384_704


# --------------------------------------------------------------------- #
# moe_ffn at moonshot's routing numbers against the reference
# --------------------------------------------------------------------- #


def _moe_cfgs():
    full = tbase.get_config("moonshot-v1-16b-a3b")
    kw = dict(d_model=64, moe_d_ff=32, dtype="float32")
    return (dataclasses.replace(full, **kw),
            dataclasses.replace(rbase.get_config("moonshot-v1-16b-a3b"),
                                **kw))


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


@pytest.mark.parametrize("n", [1, 2, 4, 32, 512])
def test_moe_ffn_routing_matches_reference(n, monkeypatch):
    cfg, rcfg = _moe_cfgs()
    assert (cfg.n_experts, cfg.top_k, cfg.n_shared_experts,
            cfg.capacity_factor) == (64, 6, 2, 1.25)
    rp = jax.tree.map(np.asarray, rmoe.moe_params(KEY, rcfg))
    tp = tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)), rp)
    x = (np.random.default_rng(n).standard_normal((1, n, cfg.d_model))
         .astype(np.float32))

    chosen = {}
    real_top_k = jax.lax.top_k

    def ref_tap(probs, k):
        out = real_top_k(probs, k)
        chosen["ref"] = np.asarray(out[1])
        return out

    port_top_k = moe_mod.top_k

    def port_tap(probs, k):
        out = port_top_k(probs, k)
        chosen["port"] = out[1]
        return out

    monkeypatch.setattr(jax.lax, "top_k", ref_tap)
    monkeypatch.setattr(moe_mod, "top_k", port_tap)
    ry, raux = rmoe.moe_ffn(rcfg, rp, jnp.asarray(x))   # eager: the tap runs
    ty, taux = moe_mod.moe_ffn(cfg, tp, torch.from_numpy(x))

    cap = moe_mod.capacity(cfg, n)
    assert cap == int(np.ceil(n * 6 / 64 * 1.25))
    np.testing.assert_array_equal(chosen["port"].numpy(), chosen["ref"])
    _, ok = moe_mod.dispatch(chosen["port"].reshape(-1), cfg.n_experts, cap)
    np.testing.assert_array_equal(ok.numpy(),
                                  _reference_drops(chosen["ref"], cap))
    if n >= 32:   # capacity binds: some choices are dropped
        assert not ok.all()
    np.testing.assert_allclose(ty.numpy(), np.asarray(ry), rtol=0,
                               atol=MOE_TOL)
    for k in raux:
        np.testing.assert_allclose(float(taux[k]), float(raux[k]),
                                   rtol=AUX_TOL)


# --------------------------------------------------------------------- #
# moonshot at 4 layers and seamless with a long memory, narrow
# --------------------------------------------------------------------- #

NARROW = {
    "moonshot-v1-16b-a3b": dict(n_layers=4, d_model=128, n_heads=4,
                                n_kv_heads=4, head_dim=32, moe_d_ff=64,
                                vocab_size=512, vocab_pad_multiple=128,
                                remat="none"),
    "seamless-m4t-large-v2": dict(n_layers=2, n_encoder_layers=2,
                                  d_model=128, n_heads=4, n_kv_heads=4,
                                  head_dim=32, d_ff=256, vocab_size=512,
                                  vocab_pad_multiple=128, remat="none"),
}
FRAMES, TOKENS, STEPS = 48, 16, 4


@pytest.mark.parametrize("arch", sorted(NARROW))
def test_narrow_prefill_and_decode_match_reference(arch):
    kw = dict(NARROW[arch], dtype="float32")
    cfg = dataclasses.replace(tbase.get_config(arch), **kw)
    rcfg = dataclasses.replace(rbase.get_config(arch), **kw)
    if cfg.moe:
        assert (cfg.n_experts, cfg.top_k, cfg.first_dense_layers) == \
            (64, 6, 1)
    rp = rmodel.init_params(rcfg, KEY)
    tp = params_from_reference(cfg, jax.tree.map(np.asarray, rp),
                               device="cpu")
    rng = np.random.default_rng(3)
    prompt = {"tokens": rng.integers(0, cfg.vocab_size, (2, TOKENS),
                                     dtype=np.int32)}
    if cfg.encoder_decoder:
        prompt["frames"] = (rng.standard_normal((2, FRAMES, cfg.d_model))
                            * 0.02).astype(np.float32)
    max_len = TOKENS + STEPS
    rlog, rc, rmem = jax.jit(
        lambda p, b: rmodel.prefill(rcfg, p, b, max_len))(
            rp, {k: jnp.asarray(v) for k, v in prompt.items()})
    tlog, tc, tmem = tmodel.prefill(
        cfg, tp, {k: torch.from_numpy(v.astype(np.int64) if k == "tokens"
                                      else v) for k, v in prompt.items()},
        max_len)
    if cfg.encoder_decoder:
        assert tuple(tmem.shape) == (2, FRAMES, cfg.d_model)
        np.testing.assert_allclose(tmem.numpy(), np.asarray(rmem), rtol=0,
                                   atol=F32_TOL)
    errs = [np.abs(tlog.numpy() - np.asarray(rlog)).max()]
    rdec = jax.jit(lambda p, c, t, q: rmodel.decode_step(rcfg, p, c, t, q,
                                                         memory=rmem))
    for i in range(STEPS):
        rtok = np.asarray(jnp.argmax(rlog[:, :cfg.vocab_size], -1))
        ttok = tlog[:, :cfg.vocab_size].argmax(-1).numpy()
        np.testing.assert_array_equal(ttok, rtok)
        pos = np.full(2, TOKENS + i, np.int32)
        rlog, rc = rdec(rp, rc, jnp.asarray(rtok), jnp.asarray(pos))
        tlog, tc = tmodel.decode_step(
            cfg, tp, tc, torch.from_numpy(ttok.astype(np.int64)),
            torch.from_numpy(pos.astype(np.int64)), memory=tmem)
        errs.append(np.abs(tlog.numpy() - np.asarray(rlog)).max())
    assert max(errs) < F32_TOL, errs


# --------------------------------------------------------------------- #
# ServeEngine on an encoder-decoder: the reference's KeyError, kept
# --------------------------------------------------------------------- #


def test_serve_engine_gives_prefill_no_frames_in_both_packages():
    prompt = np.arange(1, 9, dtype=np.int32)
    ref = RServeEngine(rbase.get_smoke_config("seamless-m4t-large-v2"),
                       max_batch=2, max_len=32, eos_id=-1)
    ref.submit(RRequest(rid=0, prompt=prompt, max_new_tokens=4))
    with pytest.raises(KeyError, match="frames"):
        ref.tick()
    port = ServeEngine(tbase.get_smoke_config("seamless-m4t-large-v2"),
                       max_batch=2, max_len=32, eos_id=-1, device="cpu")
    try:
        port.submit(Request(rid=0, prompt=prompt, max_new_tokens=4))
        with pytest.raises(KeyError, match="frames"):
            port.tick()
    finally:
        port.close()


# --------------------------------------------------------------------- #
# select_backend's device keyword: a kept divergence
# --------------------------------------------------------------------- #


def _checker():
    path = ROOT / "tools" / "check_api_torch.py"
    spec = importlib.util.spec_from_file_location("check_api_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("require,width", [
    ("fused", None), ("fused", 16), ("fused", 32), ("fused", 64),
    ("eager", None)])
def test_select_backend_requires_device(require, width):
    with pytest.raises(TypeError, match="device"):
        select_backend(require=require, width=width)
    want = ref_select_backend(require=require, width=width).name
    got = select_backend(require=require, width=width, device="cpu").name
    assert got == _checker().RENAMED_BACKENDS.get(want, want)


def test_checker_lists_select_backends_device(monkeypatch, capsys):
    mod = _checker()
    assert mod.EXTRA["select_backend"] == ["device"]
    assert mod.main([]) == 0
    monkeypatch.setattr(mod, "EXTRA", {k: v for k, v in mod.EXTRA.items()
                                       if k != "select_backend"})
    assert mod.main([]) == 1
    assert "select_backend: surface drift — unexpected exports ['device']" \
        in capsys.readouterr().err
