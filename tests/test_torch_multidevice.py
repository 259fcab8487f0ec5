"""The LM cells executed across ranks under their sharding specs.

The counterparts of ``tests/distributed/test_multidevice.py:42,84,111``:
8 CPU ranks on the ``gloo`` backend, started by
``repro_torch.distributed.spawn.run_ranks`` (the reference forces 8 host
devices in a child interpreter), run every sharded case once
(:func:`_rank_cases`); the parent holds their gathered outputs against
the port's unsharded run and, where the reference test has one, the
reference's unsharded ``jax.jit`` run from the same parameters
(``convert.params_from_reference``):

* the qwen3-1.7b smoke train step (``TrainConfig(z_loss=0.0)``, seq 32,
  global batch 8) on the ``(4, 2)`` mesh: float32 loss within rtol 1e-5
  and every updated leaf within 1e-5 of its max|p|; bfloat16 within the
  reference test's loss rtol 1e-3 and embedding rtol 5e-3 / atol 1e-4,
  and the AdamW moments (the gradients; the first step's learning rate
  is 0) within 2**-3 of each leaf's max, which a planted fault in the
  gradients' sum over ranks fails;
  with ``grad_compression=True`` the loss within rtol 1e-5 and the int8
  error feedback equal but where a code rounds the other way;
* ``build_cell``'s ``train_tiny`` (32 x 8) and ``decode_tiny`` (64 x 8)
  cells in float32 through ``Cell.run`` on ``(4, 2)``, each placed
  leaf's local shape equal to ``sharding.local_shape``;
* the moonshot-v1-16b-a3b smoke ``moe_ffn`` with ``x`` sharded over
  ``data`` on ``(2, 4)``, within rtol 2e-3 / atol 2e-5;
* a ``serve_seq_parallel`` prefill on ``(2, 4)`` (the sequence sharded
  over ``model``) against the plain prefill, and the decode cache write
  (``attention.write_slots``) on a cache sharded over batch and heads.

Single-process tests pin the ``P`` -> placements mapping, the rule by
which ``maybe_shard`` drops absent axes, ``gather_layer_params`` and the
dry run's census on DTensors of the ``fake`` backend.
"""

from __future__ import annotations

import dataclasses
import functools
import time
import traceback

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.steps as ref_steps
from repro.config.base import TrainConfig as RefTrainConfig
from repro.config.base import get_smoke_config as ref_smoke
from repro.data.pipeline import DataConfig, SyntheticLM
from repro.models import moe as ref_moe
from repro.train.trainer import init_train_state as ref_init_train_state

from repro_torch.config.base import ShapeConfig, TrainConfig, get_smoke_config
from repro_torch.convert import opt_state_from_reference, params_from_reference
from repro_torch.distributed.constraints import (clean_spec,
                                                 gather_layer_params,
                                                 maybe_shard, use_mesh)
from repro_torch.distributed.sharding import P, placements
from repro_torch.distributed.spawn import run_ranks
from repro_torch.models.tree import tree_items, tree_map

WORLD = 8
RANKS_TIMEOUT_S = 400   # a hang guard; the ranks take ~45 s
ARCH = "qwen3-1.7b"
MOE_ARCH = "moonshot-v1-16b-a3b"
F32_RTOL = 1e-5
# A bfloat16 gradient leaf of the sharded step against the unsharded one,
# as a share of the leaf's largest magnitude: the data shards round their
# partial products apart, most in the leaves whose gradient is a nearly
# cancelling sum (the k bias, the norm scales).
BF16_GRAD_MAX_REL = 2.0 ** -3
TINY = {"train": ("train_tiny", "train", 32, 8),
        "decode": ("decode_tiny", "decode", 64, 8),
        "prefill": ("prefill_tiny", "prefill", 32, 4)}


# --------------------------------------------------------------------- #
# The ranks' side
# --------------------------------------------------------------------- #


def _mesh(shape):
    from repro_torch.launch.mesh import Mesh, device_mesh
    mesh = Mesh(("data", "model"), shape, (torch.device("cpu"),) * WORLD)
    return mesh, device_mesh(mesh)


def _patched_cell(kind, shape, dtype, tcfg=None):
    """``build_cell`` for ``ARCH`` resolved to its smoke config in
    ``dtype`` (as the reference test patches ``steps.get_config``)."""
    import repro_torch.launch.steps as steps
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype=dtype)
    real = steps.get_config
    steps.get_config = lambda arch: cfg
    try:
        mesh, dm = _mesh(shape)
        cell = steps.build_cell(ARCH, ShapeConfig(*TINY[kind]), mesh, tcfg)
    finally:
        steps.get_config = real
    return cfg, mesh, dm, cell


def _placed(cell, args, dm, mesh):
    """``args`` placed by the cell's shardings, and whether every leaf's
    local shape is ``local_shape`` of its spec."""
    from repro_torch.distributed.sharding import distribute_tree, local_shape
    placed = distribute_tree(tuple(args), cell.in_shardings, dm)
    ok = all(tuple(x.to_local().shape)
             == local_shape(x.shape, sh.spec, mesh)
             for (_, x), (_, sh) in zip(tree_items(placed),
                                        tree_items(cell.in_shardings)))
    return placed, ok


def _host(tree):
    from repro_torch.distributed.sharding import gather_tree
    return tree_map(lambda x: x.detach().cpu().clone(), gather_tree(tree))


def _keep_partial(x):
    """``x`` with each rank's own partial sum taken as the whole (the sum
    over ranks skipped)."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor) or not any(
            pl.is_partial() for pl in x.placements):
        return x
    return DTensor.from_local(
        x.to_local(), x.device_mesh,
        [Replicate() if pl.is_partial() else pl for pl in x.placements],
        shape=x.shape, stride=x.stride())


def _case_train(dtype, gc, params, tokens, grad_sums_kept=False):
    """The sharded train step; ``grad_sums_kept`` plants a fault in the
    backward only: gradients that reach ``layout_like`` as partial sums
    keep each rank's own part."""
    import repro_torch.train.trainer as trainer
    tcfg = TrainConfig(z_loss=0.0, grad_compression=gc)
    cfg, mesh, dm, cell = _patched_cell("train", (4, 2), dtype, tcfg)
    p = params_from_reference(cfg, params, device="cpu")
    opt = tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype),
                   cell.args[1])
    placed, ok = _placed(cell, (p, opt, {"tokens": torch.from_numpy(
        tokens)}), dm, mesh)
    real = trainer.layout_like
    if grad_sums_kept:
        trainer.layout_like = lambda x, ref: real(_keep_partial(x), ref)
    try:
        return {"out": _host(cell.run(placed, dm)), "local_ok": ok}
    finally:
        trainer.layout_like = real


def _case_cell(kind, params, inputs):
    cfg, mesh, dm, cell = _patched_cell(kind, (4, 2), "float32")
    p = params_from_reference(cfg, params, device="cpu")
    args = (p,) + tuple(tree_map(torch.from_numpy, inputs))
    placed, ok = _placed(cell, args, dm, mesh)
    return {"out": _host(cell.run(placed, dm)), "local_ok": ok}


def _case_moe(params, x):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.models import moe
    _, dm = _mesh((2, 4))
    cfg = get_smoke_config(MOE_ARCH)
    p = tree_map(lambda a: distribute_tensor(torch.from_numpy(a), dm,
                                             [Replicate(), Replicate()]),
                 params)
    xs = distribute_tensor(torch.from_numpy(x), dm, [Shard(0), Replicate()])
    with use_mesh(dm), implicit_replication():
        y, aux = moe.moe_ffn(cfg, p, xs)
    return {"y": _host(y), "aux": _host(aux), "x_local": tuple(
        xs.to_local().shape)}


def _case_sp_prefill(params, tokens):
    import repro_torch.models.model as lm
    cfg, mesh, dm, cell = _patched_cell("prefill", (2, 4), "float32")
    real, seen = lm.maybe_shard, []

    def spy(x, *spec):
        out = real(x, *spec)
        if hasattr(out, "placements"):
            seen.append(str(out.placements))
        return out

    lm.maybe_shard = spy
    try:
        p = params_from_reference(cfg, params, device="cpu")
        placed, ok = _placed(cell, (p, {"tokens": torch.from_numpy(tokens)}),
                             dm, mesh)
        out = _host(cell.run(placed, dm))
    finally:
        lm.maybe_shard = real
    return {"out": out, "local_ok": ok, "pinned": seen}


def _case_cache_write(cache, idx, value):
    from torch.distributed.tensor import Shard, distribute_tensor
    from repro_torch.models.attention import write_slots
    _, dm = _mesh((2, 4))
    c = distribute_tensor(torch.from_numpy(cache), dm, [Shard(0), Shard(2)])
    i = distribute_tensor(torch.from_numpy(idx), dm, [Shard(0), Shard(0)])
    v = distribute_tensor(torch.from_numpy(value), dm,
                          [Shard(0), Shard(1)])
    before = c.to_local().data_ptr()
    write_slots(c, i, v)
    return {"cache": _host(c), "in_place": c.to_local().data_ptr() == before,
            "placements": str(c.placements)}


CASES = {"train": _case_train, "cell": _case_cell, "moe": _case_moe,
         "sp_prefill": _case_sp_prefill, "cache_write": _case_cache_write}


def _rank_cases(rank: int, world: int, jobs: list) -> dict:
    """Every job on this rank, in order; a job that raises records its
    traceback (the ranks raise alike, so later jobs still meet)."""
    out = {}
    for name, case, kwargs in jobs:
        t0 = time.perf_counter()
        try:
            out[name] = CASES[case](**kwargs)
        except Exception:  # noqa: BLE001 — reported by the job's test
            out[name] = {"error": traceback.format_exc()}
        out[name]["seconds"] = time.perf_counter() - t0
    return out if rank == 0 else {}


# --------------------------------------------------------------------- #
# The parent's side: inputs, the reference runs, one spawn for all
# --------------------------------------------------------------------- #


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


@functools.cache
def _train_inputs(gc: bool):
    cfg = ref_smoke(ARCH)
    tcfg = RefTrainConfig(z_loss=0.0, grad_compression=gc)
    params, opt = ref_init_train_state(cfg, tcfg, jax.random.PRNGKey(0))
    batch = SyntheticLM(DataConfig(seq_len=32, global_batch=8,
                                   vocab_size=cfg.vocab_size)).batch(0)
    return _np(params), _np(opt), np.asarray(batch["tokens"])


@functools.cache
def _cell_inputs(kind: str):
    cfg = ref_smoke(ARCH)
    params = _np(ref_steps.init_params(cfg, jax.random.PRNGKey(1)))
    rng = np.random.default_rng(11)
    _, _, s, b = TINY[kind]
    if kind == "prefill":
        return params, ({"tokens": rng.integers(
            0, cfg.vocab_size, (b, s)).astype(np.int64)},)
    from repro_torch.models.model import init_cache
    pcfg = get_smoke_config(ARCH)
    caches = tree_map(lambda t: rng.normal(0, 1, t.shape).astype(np.float32),
                      init_cache(pcfg, b, s, torch.float32, device="meta"))
    tok = rng.integers(0, cfg.vocab_size, (b,)).astype(np.int64)
    pos = rng.integers(0, s, (b,)).astype(np.int64)
    return params, (caches, tok, pos)


@functools.cache
def _moe_inputs():
    cfg = ref_smoke(MOE_ARCH)
    p = _np(ref_moe.moe_params(jax.random.PRNGKey(0), cfg))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                     (4, 16, cfg.d_model)))
    return p, x


@functools.cache
def _cache_inputs():
    rng = np.random.default_rng(5)
    cache = rng.normal(0, 1, (8, 16, 4, 8)).astype(np.float32)
    idx = rng.integers(0, 16, (8,)).astype(np.int64)
    value = rng.normal(0, 1, (8, 4, 8)).astype(np.float32)
    return cache, idx, value


def _jobs() -> list:
    jobs = []
    for dtype in ("float32", "bfloat16"):
        params, _, tokens = _train_inputs(False)
        jobs.append((f"train_{dtype}", "train", dict(
            dtype=dtype, gc=False, params=params, tokens=tokens)))
    jobs.append(("train_bfloat16_grad_sums_kept", "train", dict(
        dtype="bfloat16", gc=False, params=params, tokens=tokens,
        grad_sums_kept=True)))
    params, _, tokens = _train_inputs(True)
    jobs.append(("train_gc", "train", dict(dtype="float32", gc=True,
                                           params=params, tokens=tokens)))
    params, inputs = _cell_inputs("decode")
    jobs.append(("cell_decode", "cell", dict(kind="decode", params=params,
                                             inputs=inputs)))
    p, x = _moe_inputs()
    jobs.append(("moe", "moe", dict(params=p, x=x)))
    params, (batch,) = _cell_inputs("prefill")
    jobs.append(("sp_prefill", "sp_prefill", dict(params=params,
                                                  tokens=batch["tokens"])))
    cache, idx, value = _cache_inputs()
    jobs.append(("cache_write", "cache_write", dict(cache=cache, idx=idx,
                                                    value=value)))
    return jobs


@pytest.fixture(scope="module")
def sharded():
    """Rank 0's results of every sharded job: one spawn of 8 ranks."""
    return run_ranks(_rank_cases, WORLD, _jobs(), device="cpu",
                     timeout_s=RANKS_TIMEOUT_S)[0]


def _result(sharded, name):
    res = sharded[name]
    assert "error" not in res, res.get("error")
    return res


def _rel_err(got, want) -> float:
    got, want = got.detach().float(), torch.as_tensor(
        np.asarray(want, np.float32))
    return float((got - want).abs().max()
                 / max(float(want.abs().max()), 1e-30))


def _allclose(got, want, rtol, atol) -> bool:
    return np.allclose(got.detach().float().numpy(),
                       np.asarray(want, np.float32), rtol=rtol, atol=atol)


@functools.cache
def _plain_train(dtype: str, gc: bool):
    """The unsharded port step and the reference's ``jax.jit`` step from
    the same parameters and batch."""
    params, opt, tokens = _train_inputs(gc)
    rcfg = dataclasses.replace(ref_smoke(ARCH), dtype=dtype)
    rstep = ref_steps.build_train_step(
        rcfg, RefTrainConfig(z_loss=0.0, grad_compression=gc))
    rout = jax.jit(rstep)(jax.tree.map(jnp.asarray, params),
                          jax.tree.map(jnp.asarray, opt),
                          {"tokens": jnp.asarray(tokens)})
    tcfg = dataclasses.replace(get_smoke_config(ARCH), dtype=dtype)
    from repro_torch.train.trainer import build_train_step
    tstep = build_train_step(tcfg, TrainConfig(z_loss=0.0,
                                               grad_compression=gc))
    tout = tstep(params_from_reference(tcfg, params, device="cpu"),
                 opt_state_from_reference(tcfg, opt, device="cpu"),
                 {"tokens": torch.from_numpy(tokens.astype(np.int64))})
    return tout, _np(rout)


# --------------------------------------------------------------------- #
# tests/distributed/test_multidevice.py:42 — the sharded train step
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("against", ["port", "reference"])
def test_sharded_train_step_float32(sharded, against):
    res = _result(sharded, "train_float32")
    assert res["local_ok"]
    port, ref = _plain_train("float32", False)
    p, o, m = res["out"]
    wp, wo, wm = port if against == "port" else ref
    np.testing.assert_allclose(float(m["loss"]), float(wm["loss"]),
                               rtol=F32_RTOL)
    want = dict(tree_items({"params": wp, "mu": wo["mu"], "nu": wo["nu"]}))
    for path, x in tree_items({"params": p, "mu": o["mu"], "nu": o["nu"]}):
        assert _rel_err(x, _as_np(want[path])) <= F32_RTOL, path
    assert int(o["step"]) == 1


def _as_np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else x


def _moment_errs(o, wo) -> dict:
    """Per AdamW moment leaf: max |a - b| / max |b|."""
    want = dict(tree_items({"mu": wo["mu"], "nu": wo["nu"]}))
    return {path: _rel_err(x, _as_np(want[path]))
            for path, x in tree_items({"mu": o["mu"], "nu": o["nu"]})}


@pytest.mark.parametrize("against", ["port", "reference"])
def test_sharded_train_step_bfloat16(sharded, against):
    """The reference test's own tolerances (bf16 reduction orders) on the
    loss and the embedding. The first step's learning rate is 0, so the
    parameters cannot show the gradients; its AdamW moments (mu = 0.1 g,
    nu = 0.05 g**2) do: every leaf within ``BF16_GRAD_MAX_REL`` of its
    largest magnitude."""
    res = _result(sharded, "train_bfloat16")
    assert res["local_ok"]
    port, ref = _plain_train("bfloat16", False)
    wp, wo, wm = port if against == "port" else ref
    p, o, m = res["out"]
    np.testing.assert_allclose(float(m["loss"]), float(wm["loss"]),
                               rtol=1e-3)
    assert _allclose(p["embed"]["embedding"],
                     _as_np(wp["embed"]["embedding"]), rtol=5e-3, atol=1e-4)
    for path, err in _moment_errs(o, wo).items():
        assert err <= BF16_GRAD_MAX_REL, (path, err)


def test_sharded_train_step_bfloat16_sees_unsummed_grads(sharded):
    """A fault in the backward only (gradients that arrive as partial
    sums keep each rank's own part): the loss is untouched, and the
    moments' check above fails on it."""
    res = _result(sharded, "train_bfloat16_grad_sums_kept")
    (_, wo, wm), _ = _plain_train("bfloat16", False)
    _, o, m = res["out"]
    np.testing.assert_allclose(float(m["loss"]), float(wm["loss"]),
                               rtol=1e-3)
    errs = _moment_errs(o, wo)
    assert max(errs.values()) > 4 * BF16_GRAD_MAX_REL, errs


def test_sharded_train_step_grad_compression(sharded):
    """int8 error feedback composes with the sharded step. The loss, and
    the corrected gradient the codes quantize (``err + deq``, ``deq`` read
    back from ``mu`` through the clip scale), are continuous in the inputs
    and hold at 1e-5. Each int8 code is ``round(g / scale)``: where a
    gradient lies within the shards' float32 rounding of a half-quantum
    the code differs by one and that element's ``err`` by one quantum,
    at most 0.1% of each leaf."""
    res = _result(sharded, "train_gc")
    (wp, wo, wm), ref = _plain_train("float32", True)
    p, o, m = res["out"]
    np.testing.assert_allclose(float(m["loss"]), float(wm["loss"]),
                               rtol=F32_RTOL)
    np.testing.assert_allclose(float(m["loss"]), float(ref[2]["loss"]),
                               rtol=F32_RTOL)
    assert res["local_ok"] and set(o) == {"mu", "nu", "step", "err"}
    b1 = TrainConfig().beta1

    def corrected(opt, metrics):
        clip = min(1.0, TrainConfig().grad_clip
                   / (float(metrics["grad_norm"]) + 1e-9))
        return tree_map(lambda e, mu: e + mu.detach() / ((1 - b1) * clip),
                        opt["err"], opt["mu"])

    want_g = dict(tree_items(corrected(wo, wm)))
    want_e = dict(tree_items(wo["err"]))
    for path, g in tree_items(corrected(o, m)):
        top = float(want_g[path].abs().max())
        assert float((g - want_g[path]).abs().max()) <= F32_RTOL * top, path
        got_e = dict(tree_items(o["err"]))[path]
        flips = (got_e - want_e[path]).abs() > F32_RTOL * top
        assert float(flips.float().mean()) <= 1e-3, path
    for path, x in tree_items(p):
        assert _rel_err(x, dict(tree_items(wp))[path].detach().numpy()) \
            <= F32_RTOL, path


# --------------------------------------------------------------------- #
# tests/distributed/test_multidevice.py:84 — build_cell on the mesh
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_cell_runs_on_mesh(sharded, kind):
    """``build_cell``'s ``train_tiny`` (the float32 train job above: the
    smoke cell with ``TrainConfig(z_loss=0.0)``) and ``decode_tiny`` in
    float32 through ``Cell.run`` on (4, 2), every output leaf against the
    same cell's ``fn`` unsharded in one process."""
    import repro_torch.launch.steps as steps
    from repro_torch.launch.mesh import make_test_mesh
    res = _result(sharded, "train_float32" if kind == "train"
                  else "cell_decode")
    assert res["local_ok"]
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    real = steps.get_config
    steps.get_config = lambda arch: cfg
    try:
        cell = steps.build_cell(ARCH, ShapeConfig(*TINY[kind]),
                                make_test_mesh(devices=["cpu"]),
                                TrainConfig(z_loss=0.0))
    finally:
        steps.get_config = real
    if kind == "train":
        params, opt, tokens = _train_inputs(False)
        args = (opt_state_from_reference(cfg, opt, device="cpu"),
                {"tokens": torch.from_numpy(tokens)})
    else:
        params, inputs = _cell_inputs(kind)
        args = tree_map(lambda a: torch.from_numpy(a.copy()), inputs)
    want = cell.fn(params_from_reference(cfg, params, device="cpu"), *args)
    got = dict(tree_items(res["out"]))
    assert sorted(got) == sorted(path for path, _ in tree_items(want))
    for path, w in tree_items(want):
        if w.is_floating_point():
            assert _rel_err(got[path], w.detach().numpy()) <= F32_RTOL, path
        else:
            assert torch.equal(got[path], w), path


# --------------------------------------------------------------------- #
# tests/distributed/test_multidevice.py:111 — MoE with x over data
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("against", ["port", "reference"])
def test_moe_ep_sharding_correct(sharded, against):
    from repro_torch.models import moe
    res = _result(sharded, "moe")
    p, x = _moe_inputs()
    assert res["x_local"] == (x.shape[0] // 2,) + x.shape[1:]
    if against == "port":
        y, aux = moe.moe_ffn(get_smoke_config(MOE_ARCH),
                             tree_map(torch.from_numpy, p),
                             torch.from_numpy(x))
        y, lb = y.numpy(), float(aux["load_balance_loss"])
    else:
        y, aux = ref_moe.moe_ffn(ref_smoke(MOE_ARCH),
                                 jax.tree.map(jnp.asarray, p),
                                 jnp.asarray(x))
        y, lb = np.asarray(y), float(aux["load_balance_loss"])
    assert _allclose(res["y"], y, rtol=2e-3, atol=2e-5)
    # The expert counts come from the dispatch integers.
    np.testing.assert_allclose(float(res["aux"]["load_balance_loss"]), lb,
                               rtol=1e-5)


# --------------------------------------------------------------------- #
# The sequence-parallel serving branches and the cache write
# --------------------------------------------------------------------- #


def test_serve_seq_parallel_prefill_on_mesh(sharded):
    """A small model's prefill cell on (2, 4): the sequence sharded over
    ``model`` after the embedding (the constraint acts), K/V gathered,
    outputs equal to the plain prefill within 1e-5 in float32."""
    from repro_torch.models import model as lm
    res = _result(sharded, "sp_prefill")
    assert res["local_ok"]
    assert "(Shard(dim=0), Shard(dim=1))" in res["pinned"]
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    params, (batch,) = _cell_inputs("prefill")
    want = lm.prefill(cfg, params_from_reference(cfg, params, device="cpu"),
                      {"tokens": torch.from_numpy(batch["tokens"])},
                      TINY["prefill"][2])
    got = dict(tree_items(res["out"]))
    for path, w in tree_items(want):
        assert _rel_err(got[path], w.detach().numpy()) <= F32_RTOL, path


def test_decode_cache_write_on_sharded_cache(sharded):
    """``write_slots`` into a cache sharded over batch (``data``) and
    heads (``model``): in place, layout kept, bit-equal to the plain
    write."""
    from repro_torch.models.attention import write_slots
    res = _result(sharded, "cache_write")
    cache, idx, value = _cache_inputs()
    want = write_slots(torch.from_numpy(cache.copy()),
                       torch.from_numpy(idx), torch.from_numpy(value))
    assert res["in_place"]
    assert res["placements"] == "(Shard(dim=0), Shard(dim=2))"
    assert torch.equal(res["cache"], want)


# --------------------------------------------------------------------- #
# Single process: placements, the collapse rule, the layer gather
# --------------------------------------------------------------------- #


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard
    dm = ("data", "model")
    assert placements(P("data", None), dm) == (Shard(0), Replicate())
    assert placements(P(None, "model", None), dm) == (Replicate(), Shard(1))
    assert placements(P(), dm) == (Replicate(), Replicate())
    assert placements(P(("data", "model")), dm) == (Shard(0), Shard(0))
    pod = ("pod", "data", "model")
    assert placements(P(("pod", "data"), None, "model"), pod) == (
        Shard(0), Shard(0), Shard(2))
    with pytest.raises(ValueError):
        placements(P(("model", "data")), dm)       # out of mesh order
    with pytest.raises(ValueError):
        placements(P("data", "data"), dm)          # one axis twice
    with pytest.raises(ValueError):
        placements(P("pod"), dm)                   # no such axis


def test_clean_spec_drops_absent_axes():
    """The reference's ``ok()``: tuples keep the axes the mesh has, names
    it lacks become ``None``."""
    axes = ("data", "model")
    assert clean_spec((("pod", "data"), None, "model"), axes) == (
        ("data",), None, "model")
    assert clean_spec(("pod", ("pod",)), axes) == (None, None)
    assert clean_spec((None, "model"), ("data",)) == (None, None)


@pytest.fixture
def fake_mesh():
    """A (4, 2) ``DeviceMesh`` over a ``fake`` process group of 8 ranks
    in this process (rank 0), torn down after the test."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.mesh import Mesh, device_mesh
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield device_mesh(Mesh(("data", "model"), (4, 2)), device_type="cpu")
    finally:
        dist.destroy_process_group()


def _meta(dm, shape, pl):
    from torch.distributed.tensor import DTensor
    local = list(shape)
    for i, p in enumerate(pl):
        if p.is_shard():
            local[p.dim] //= dm.size(i)
    return DTensor.from_local(torch.empty(local, device="meta"), dm, pl,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape,
                                                 device="meta").stride())


def test_maybe_shard_redistributes_under_a_mesh(fake_mesh):
    from torch.distributed.tensor import Replicate, Shard
    dm = fake_mesh
    x = _meta(dm, (8, 6, 4), (Replicate(), Replicate()))
    plain = torch.zeros(8, 6, 4)
    # no mesh current: identities
    assert maybe_shard(x, "data", None, "model") is x
    with use_mesh(dm):
        y = maybe_shard(x, ("pod", "data"), None, "model")
        assert y.placements == (Shard(0), Shard(2))
        assert tuple(y.to_local().shape) == (2, 6, 2)
        assert maybe_shard(x, "pod", None) is x        # collapses fully
        assert maybe_shard(plain, "data") is plain     # plain tensor
        z = maybe_shard(y, None, "data")
        assert z.placements == (Shard(1), Replicate())


def test_gather_layer_params_drops_the_fsdp_factor(fake_mesh):
    """One layer's FSDP-sharded weights come out TP-only (the spec
    ``param_pspec(..., dsize=1, fsdp=False)``), identities with no
    mesh."""
    from torch.distributed.tensor import Replicate, Shard
    dm = fake_mesh
    cfg = get_smoke_config(ARCH)
    lp = {"attn": {"wq": _meta(dm, (64, 4, 16), (Shard(0), Shard(1)))},
          "mlp": {"w_down": _meta(dm, (128, 64), (Shard(1), Shard(0)))},
          "ln1": {"scale": _meta(dm, (64,), (Shard(0), Replicate()))}}
    assert gather_layer_params(cfg, lp) is lp
    with use_mesh(dm):
        out = gather_layer_params(cfg, lp)
    assert out["attn"]["wq"].placements == (Replicate(), Shard(1))
    assert out["mlp"]["w_down"].placements == (Replicate(), Shard(0))
    assert out["ln1"]["scale"].placements == (Replicate(), Replicate())


def test_census_counts_each_collective_by_its_own_op(fake_mesh):
    """The dry run's census names a collective by the op dispatched: a
    partial sum made whole is an all-reduce of the result's bytes; a
    shard moved between dims on a CPU mesh (gloo has no all-to-all) is
    the all-gather DTensor issues for it."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from repro_torch.launch.dryrun import collective_bytes
    dm = fake_mesh
    x = _meta(dm, (8, 6, 4), (Replicate(), Partial()))
    y = _meta(dm, (8, 6, 4), (Shard(0), Replicate()))
    with collective_bytes() as census:
        x.redistribute(dm, (Replicate(), Replicate()))
    assert census.bytes == {"all-reduce": 8 * 6 * 4 * 4}
    with collective_bytes() as census:
        y.redistribute(dm, (Shard(1), Replicate()))
    assert set(census.bytes) == {"all-gather"}
