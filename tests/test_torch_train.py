"""The port's LM train path (optimizer, gradient compression, trainer,
data, checkpoint, fault tolerance, the launcher) against the reference,
on the CPU.

* ``tests/train/test_train_stack.py:26-230`` and every test of
  ``tests/distributed/test_fault_tolerance.py`` run through both packages
  (the ``P`` fixture; the port with ``device="cpu"``), with the
  reference's own tolerances.
* Reference against port, on the same seeded NumPy inputs:
  - ``adamw_update``, ``sgd_momentum_update``, ``clip_by_global_norm``
    (its norm summed in JAX's leaf order) and ``warmup_cosine`` on seeded
    trees, float32, rtol 1e-6;
  - the int8 payload and scale bit-exact, round-half-to-even ties
    included, and the error-feedback loop bit-exact;
  - ``compress_grads_sign_with_feedback`` and ``pum_sign_majority3``
    bit-exact, with the PuM devices' ``EngineStats`` identical, eager and
    fused;
  - ``build_train_step`` for 3 steps from the reference's params and
    AdamW state (``convert.params_from_reference`` /
    ``opt_state_from_reference``) on qwen1.5, mamba2 and deepseek smoke
    configs in float32, microbatches 1 and 2, int8 compression off and
    on: every metric within 1e-5 relative (measured at most ~4e-7);
  - checkpoints: one written by either package's ``CheckpointManager``
    restores in the other with equal values and ``meta``.
* The launcher with ``--device cpu``: a simulated preemption exits 42
  with step 5 saved; a rerun resumes at 5 and ends at 12, and its step-5
  line equals an uninterrupted run's.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import pathlib
import subprocess
import sys
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.convert import opt_state_from_reference, \
    params_from_reference
from repro_torch.models.tree import tree_items, tree_leaves

PACKAGES = ["repro", "repro_torch"]
ROOT = pathlib.Path(__file__).resolve().parents[1]
OPT_RTOL = 1e-6
STEP_RTOL = 1e-5


def _ns(name: str) -> types.SimpleNamespace:
    ns = types.SimpleNamespace(name=name)
    for attr, mod in (("base", "config.base"), ("opt", "train.optimizer"),
                      ("gc", "train.grad_compress"),
                      ("trainer", "train.trainer"),
                      ("data", "data.pipeline"),
                      ("ckpt", "checkpoint.manager"),
                      ("ft", "distributed.fault_tolerance"),
                      ("model", "models.model"), ("pum", "pum")):
        setattr(ns, attr, importlib.import_module(f"{name}.{mod}"))
    if name == "repro":
        ns.arr = lambda a: jnp.asarray(np.asarray(a, np.float32))
        ns.int = lambda v: jnp.array(v)
        ns.zeros = lambda n: jnp.zeros(n)
        ns.np = lambda x: np.asarray(x)
        ns.init_state = lambda cfg, t: ns.trainer.init_train_state(
            cfg, t, jax.random.PRNGKey(0))
        ns.batch = lambda b: jax.tree.map(jnp.asarray, b)
        ns.train_loop = ns.trainer.train_loop
        ns.device = lambda **kw: ns.pum.device(**kw)
    else:
        ns.arr = lambda a: torch.tensor(np.asarray(a, np.float32))
        ns.int = lambda v: torch.tensor(v)
        ns.zeros = lambda n: torch.zeros(n)
        ns.np = lambda x: x.detach().numpy()
        ns.init_state = lambda cfg, t: ns.trainer.init_train_state(
            cfg, t, device="cpu")
        ns.batch = lambda b: ns.trainer.device_batch(b, "cpu")
        ns.train_loop = lambda *a, **kw: ns.trainer.train_loop(
            *a, device="cpu", **kw)
        ns.device = lambda **kw: ns.pum.device(device="cpu", **kw)
    return ns


NS = {name: _ns(name) for name in PACKAGES}
R, T = NS["repro"], NS["repro_torch"]


@pytest.fixture(params=PACKAGES)
def P(request):
    return NS[request.param]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test's torch CPU ops on one thread. Under the parallel test
    workers, more torch threads than cores make its thread teams wait on
    each other: a 60-step smoke train loop took 433 s instead of 3 s."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------- #
# tests/train/test_train_stack.py:26-230 through both packages
# --------------------------------------------------------------------- #


def test_adamw_matches_reference(P):
    """One AdamW step vs a hand-rolled NumPy reference."""
    cfg = P.opt.AdamWConfig(learning_rate=1e-2, beta1=0.9, beta2=0.99,
                            eps=1e-8, weight_decay=0.01)
    p = {"w": P.arr([1.0, -2.0, 3.0])}
    g = {"w": P.arr([0.1, 0.2, -0.3])}
    st = P.opt.adamw_init(p)
    new_p, st2 = P.opt.adamw_update(cfg, p, g, st)
    mu = 0.1 * np.array([0.1, 0.2, -0.3])
    nu = 0.01 * np.array([0.1, 0.2, -0.3]) ** 2
    mhat = mu / (1 - 0.9)
    nhat = nu / (1 - 0.99)
    want = (np.array([1.0, -2.0, 3.0])
            - 1e-2 * (mhat / (np.sqrt(nhat) + 1e-8)
                      + 0.01 * np.array([1.0, -2.0, 3.0])))
    np.testing.assert_allclose(P.np(new_p["w"]), want, rtol=1e-6)
    assert int(st2["step"]) == 1


def test_grad_clip(P):
    g = {"a": P.arr(np.full((10,), 3.0))}
    clipped, norm = P.opt.clip_by_global_norm(g, 1.0)
    np.testing.assert_allclose(float(P.opt.global_norm(clipped)), 1.0,
                               rtol=1e-5)
    assert float(norm) == pytest.approx(np.sqrt(90.0), rel=1e-5)


def test_warmup_cosine_shape(P):
    assert float(P.opt.warmup_cosine(P.int(0), 10, 100)) == 0.0
    assert float(P.opt.warmup_cosine(P.int(10), 10, 100)) == \
        pytest.approx(1.0)
    assert float(P.opt.warmup_cosine(P.int(100), 10, 100)) == \
        pytest.approx(0.1, abs=1e-6)


def test_grad_compression_error_feedback(P):
    """Error feedback keeps the accumulated compressed signal unbiased:
    sum of dequantized grads ~ sum of true grads."""
    rng = np.random.default_rng(0)
    true = [P.arr(rng.standard_normal(64).astype(np.float32) * 0.01)
            for _ in range(50)]
    err = {"g": P.zeros(64)}
    acc = np.zeros(64)
    for g in true:
        deq, err_new = P.gc.compress_grads_with_feedback({"g": g}, err)
        err = err_new
        acc += P.np(deq["g"])
    want = np.sum([P.np(g) for g in true], axis=0)
    np.testing.assert_allclose(acc, want, atol=2e-3)


def test_sign_bitmaps_pack_roundtrip_and_pum_parity(P):
    """The 1-bit sign/mask path: pack/unpack round-trips, the PuM-routed
    wire bitmap and MAJ3 agree with direct NumPy, and an eager device
    produces bit-identical bitmaps (and identical cost-plane charges) to
    a fused one."""
    gc = P.gc
    rng = np.random.default_rng(7)
    t = rng.standard_normal(1000).astype(np.float32)
    sign_w, mask_w, scale = gc.sign_mask_bitmaps(t, 0.5)
    np.testing.assert_array_equal(gc.unpack_bitmap(sign_w, t.size), t < 0)
    np.testing.assert_array_equal(gc.unpack_bitmap(mask_w, t.size),
                                  np.abs(t) >= 0.5)
    assert scale == pytest.approx(float(np.abs(t[np.abs(t) >= 0.5]).mean()))

    eager = P.device(width=32, fuse=False)
    fused = P.device(width=32, fuse=True)
    wire_e = gc.pum_wire_bitmap(sign_w, mask_w, eager)
    wire_f = gc.pum_wire_bitmap(sign_w, mask_w, fused)
    np.testing.assert_array_equal(wire_e, sign_w & mask_w)
    np.testing.assert_array_equal(wire_e, wire_f)

    votes = [gc.pack_bitmap(rng.standard_normal(1000) < 0)
             for _ in range(3)]
    maj_e = gc.pum_sign_majority3(*votes, eager)
    maj_f = gc.pum_sign_majority3(*votes, fused)
    want = (votes[0] & votes[1]) | (votes[1] & votes[2]) \
        | (votes[0] & votes[2])
    np.testing.assert_array_equal(maj_e, want)
    np.testing.assert_array_equal(maj_e, maj_f)
    assert eager.stats == fused.stats
    assert eager.stats.latency_ns > 0  # the bitmap ops were priced


def test_sign_compression_error_feedback_tracks_true_grads(P):
    """1-bit signSGD-style compression with error feedback stays unbiased
    over time, like the int8 path (eager and fused devices identical)."""
    rng = np.random.default_rng(1)
    true = [rng.standard_normal(256).astype(np.float32) * 0.01
            for _ in range(60)]
    accs = []
    for fuse in (False, True):
        dev = P.device(width=32, fuse=fuse)
        err = {"g": P.zeros(256)}
        acc = np.zeros(256)
        for g in true:
            deq, err = P.gc.compress_grads_sign_with_feedback(
                {"g": P.arr(g)}, err, device=dev, tau_factor=0.5)
            acc += P.np(deq["g"])
        accs.append(acc)
    np.testing.assert_array_equal(accs[0], accs[1])  # eager == fused
    want = np.sum(true, axis=0)
    cos = float(np.dot(accs[0], want)
                / (np.linalg.norm(accs[0]) * np.linalg.norm(want)))
    assert cos > 0.9


def test_train_loop_loss_decreases(P):
    cfg = P.base.get_smoke_config("qwen1.5-0.5b")
    tcfg = P.base.TrainConfig(learning_rate=1e-2, warmup_steps=5,
                              total_steps=60, checkpoint_every=0)
    data = P.data.Prefetcher(P.data.SyntheticLM(P.data.DataConfig(
        seq_len=64, global_batch=8, vocab_size=cfg.vocab_size)))
    try:
        _, _, hist = P.train_loop(cfg, tcfg, data, 60)
    finally:
        data.close()
    first = np.mean([h["loss"] for h in hist[:5]])
    last = np.mean([h["loss"] for h in hist[-5:]])
    assert last < first - 0.5, f"loss did not fall: {first} -> {last}"


def test_microbatch_accumulation_matches_full_batch(P):
    cfg = P.base.get_smoke_config("qwen1.5-0.5b")
    data = P.data.SyntheticLM(P.data.DataConfig(
        seq_len=32, global_batch=8, vocab_size=cfg.vocab_size))
    batch = P.batch(data.batch(0))
    t1 = P.base.TrainConfig(microbatches=1, grad_clip=1e9, z_loss=0.0)
    t4 = P.base.TrainConfig(microbatches=4, grad_clip=1e9, z_loss=0.0)
    params, opt = P.init_state(cfg, t1)
    p1, _, m1 = P.trainer.build_train_step(cfg, t1)(params, opt, batch)
    params, opt = P.init_state(cfg, t4)
    p4, _, m4 = P.trainer.build_train_step(cfg, t4)(params, opt, batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]),
                               rtol=2e-4)
    a = P.np(p1["embed"]["embedding"])
    b = P.np(p4["embed"]["embedding"])
    np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-5)


def test_checkpoint_roundtrip_and_resume(P, tmp_path):
    cfg = P.base.get_smoke_config("mamba2-130m")
    tcfg = P.base.TrainConfig(checkpoint_every=5, total_steps=10)
    ckpt = P.ckpt.CheckpointManager(str(tmp_path), keep=2)
    data = P.data.Prefetcher(P.data.SyntheticLM(P.data.DataConfig(
        seq_len=32, global_batch=4, vocab_size=cfg.vocab_size)))
    try:
        params, opt, _ = P.train_loop(cfg, tcfg, data, 10, checkpoint=ckpt)
    finally:
        data.close()
    ckpt.wait()
    assert ckpt.latest_step() == 10
    p2, o2, meta = ckpt.restore(10, params, opt)
    np.testing.assert_allclose(P.np(params["embed"]["embedding"]),
                               P.np(p2["embed"]["embedding"]))
    assert meta["step"] == 10
    # Retention: only `keep` checkpoints remain.
    assert len(ckpt.all_steps()) <= 2


def test_checkpoint_resume_continues(P, tmp_path):
    cfg = P.base.get_smoke_config("mamba2-130m")
    tcfg = P.base.TrainConfig(checkpoint_every=5, total_steps=20)
    ckpt = P.ckpt.CheckpointManager(str(tmp_path))
    dcfg = P.data.DataConfig(seq_len=32, global_batch=4,
                             vocab_size=cfg.vocab_size)
    data = P.data.Prefetcher(P.data.SyntheticLM(dcfg))
    try:
        P.train_loop(cfg, tcfg, data, 5, checkpoint=ckpt)  # partial run
    finally:
        data.close()
    ckpt.wait()
    data2 = P.data.Prefetcher(P.data.SyntheticLM(dcfg), start_step=5)
    try:
        _, _, hist = P.train_loop(cfg, tcfg, data2, 8, checkpoint=ckpt,
                                  resume=True)
    finally:
        data2.close()
    assert len(hist) == 3  # resumed from 5, ran to 8


def test_heartbeat_and_straggler(P):
    mon = P.ft.HeartbeatMonitor(timeout_s=0.2)
    for w in ("a", "b", "c", "d"):
        for _ in range(8):
            mon.beat(w, 0.1 if w != "d" else 0.5)
    assert mon.stragglers() == ["d"]
    time.sleep(0.3)
    mon.beat("a")
    assert set(mon.dead_workers()) == {"b", "c", "d"}


def test_elastic_mesh_plan(P):
    assert P.ft.plan_elastic_mesh(512, 16) == (32, 16)
    assert P.ft.plan_elastic_mesh(496, 16) == (31, 16)  # one node lost
    with pytest.raises(RuntimeError):
        P.ft.plan_elastic_mesh(8, 16)


# --------------------------------------------------------------------- #
# tests/distributed/test_fault_tolerance.py through both packages
# --------------------------------------------------------------------- #


def test_dead_workers_timeout_path(P):
    mon = P.ft.HeartbeatMonitor(timeout_s=5.0)
    mon.workers["w0"] = P.ft.WorkerState(last_beat=0.0)
    mon.workers["w1"] = P.ft.WorkerState(last_beat=8.0)
    assert mon.dead_workers(now=10.0) == ["w0"]
    assert mon.dead_workers(now=20.0) == ["w0", "w1"]


def test_dead_workers_epoch_zero_regression(P):
    mon = P.ft.HeartbeatMonitor(timeout_s=5.0)
    mon.workers["w0"] = P.ft.WorkerState(last_beat=100.0)
    assert mon.dead_workers(now=0.0) == []
    mon.workers["w1"] = P.ft.WorkerState(last_beat=-10.0)
    assert mon.dead_workers(now=0.0) == ["w1"]


def test_beat_revives_and_tracks_step_times(P):
    mon = P.ft.HeartbeatMonitor(timeout_s=5.0, window=3)
    mon.beat("w0", step_time_s=1.0)
    assert mon.dead_workers() == []
    for t in (2.0, 3.0, 4.0):
        mon.beat("w0", step_time_s=t)
    assert mon.workers["w0"].step_times == [2.0, 3.0, 4.0]


def test_stragglers_need_three_reporting_workers(P):
    mon = P.ft.HeartbeatMonitor()
    mon.beat("w0", step_time_s=1.0)
    mon.beat("w1", step_time_s=50.0)
    assert mon.stragglers() == []


def test_stragglers_flagged_against_median(P):
    mon = P.ft.HeartbeatMonitor(straggler_factor=2.0)
    for w in ("w0", "w1", "w2"):
        for t in (1.0, 1.1, 0.9):
            mon.beat(w, step_time_s=t)
    assert mon.stragglers() == []
    for t in (4.0, 4.0, 4.0):
        mon.beat("w2", step_time_s=t)
    assert mon.stragglers() == ["w2"]


def test_stragglers_ignore_workers_without_step_times(P):
    mon = P.ft.HeartbeatMonitor(straggler_factor=2.0)
    mon.beat("idle")
    for w in ("w0", "w1", "w2"):
        mon.beat(w, step_time_s=1.0)
    mon.beat("w2", step_time_s=9.0)
    assert mon.stragglers() == ["w2"]


def test_plan_elastic_mesh_shrinks_data_axis(P):
    assert P.ft.plan_elastic_mesh(16, 4) == (4, 4)
    assert P.ft.plan_elastic_mesh(15, 4) == (3, 4)
    assert P.ft.plan_elastic_mesh(4, 4) == (1, 4)
    with pytest.raises(RuntimeError):
        P.ft.plan_elastic_mesh(3, 4)


def test_supervisor_clean_exit(P):
    sup = P.ft.Supervisor(["-c", "raise SystemExit(0)"], max_restarts=2)
    assert sup.run() == 0
    assert sup.restarts == 0


def test_supervisor_restarts_then_gives_up(P):
    sup = P.ft.Supervisor(["-c", "raise SystemExit(7)"], max_restarts=2)
    assert sup.run() == 7
    assert sup.restarts == sup.max_restarts + 1


def test_supervisor_recovers_after_transient_failure(P, tmp_path):
    marker = tmp_path / "ckpt"
    code = (f"import pathlib,sys; p=pathlib.Path({str(marker)!r});\n"
            "sys.exit(0) if p.exists() else (p.touch(), sys.exit(1))")
    sup = P.ft.Supervisor(["-c", code], max_restarts=3)
    assert sup.run() == 0
    assert sup.restarts == 1


# --------------------------------------------------------------------- #
# Optimizer, clip, schedule: port against reference, seeded trees
# --------------------------------------------------------------------- #


def _tree(seed: int, scale: float = 1.0) -> dict:
    """A seeded float32 tree whose insertion order is not JAX's sorted
    key order (so a norm summed in insertion order would round
    differently)."""
    rng = np.random.default_rng(seed)

    def n(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return {"z": n(7), "b": {"d": n(2, 3, 2), "c": n(5)}, "a": n(3, 4),
            "layers": [n(4), n(1)]}


def _to(ns, tree):
    if isinstance(tree, dict):
        return {k: _to(ns, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(ns, v) for v in tree]
    return ns.arr(tree)


def _close(got_tree, want_tree, rtol=OPT_RTOL, atol=0.0):
    gl = tree_leaves(got_tree)
    wl = jax.tree.leaves(want_tree)
    assert len(gl) == len(wl)
    # tree_items pairs leaves in JAX's order (sorted keys)
    for (_, g), w in zip(tree_items(got_tree), wl):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=rtol,
                                   atol=atol)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def test_global_norm_sums_leaves_in_jax_order():
    grads = _tree(3, 1e3)
    want = float(R.opt.global_norm(_to(R, grads)))
    got = float(T.opt.global_norm(_to(T, grads)))
    assert got == pytest.approx(want, rel=OPT_RTOL)
    order = [leaf for _, leaf in tree_items(_to(T, grads))]
    np.testing.assert_array_equal(
        np.concatenate([_np(x).ravel() for x in order]),
        np.concatenate([np.asarray(x).ravel()
                        for x in jax.tree.leaves(_to(R, grads))]))


@pytest.mark.parametrize("max_norm", [1.0, 1e9])
def test_clip_by_global_norm_matches_reference(max_norm):
    grads = _tree(4, 0.5)
    rc, rn = R.opt.clip_by_global_norm(_to(R, grads), max_norm)
    tc, tn = T.opt.clip_by_global_norm(_to(T, grads), max_norm)
    assert float(tn) == pytest.approx(float(rn), rel=OPT_RTOL)
    _close(tc, rc)


def test_warmup_cosine_matches_reference():
    for warmup, total in ((0, 10), (5, 50), (20, 30), (10, 10)):
        for step in range(0, total + 3):
            want = float(R.opt.warmup_cosine(jnp.array(step, jnp.int32),
                                             warmup, total))
            got = float(T.opt.warmup_cosine(torch.tensor(
                step, dtype=torch.int32), warmup, total))
            assert got == pytest.approx(want, rel=OPT_RTOL, abs=1e-7), \
                (warmup, total, step)


def test_adamw_update_matches_reference():
    """Four AdamW steps on a seeded tree, each with its own seeded grads
    and a warmup-cosine lr scale: params, mu, nu and step match the
    reference, float32, rtol 1e-6; the port updates in place."""
    cfg = dict(learning_rate=3e-3, beta1=0.9, beta2=0.95, eps=1e-8,
               weight_decay=0.1)
    params = _tree(10)
    rp, tp = _to(R, params), _to(T, params)
    rs, ts = R.opt.adamw_init(rp), T.opt.adamw_init(tp)
    leaf = tp["a"]
    for i in range(4):
        g = _tree(20 + i, 10.0 ** -i)
        rscale = R.opt.warmup_cosine(rs["step"], 2, 10)
        tscale = T.opt.warmup_cosine(ts["step"], 2, 10)
        rp, rs = R.opt.adamw_update(R.opt.AdamWConfig(**cfg), rp,
                                    _to(R, g), rs, rscale)
        tp, ts = T.opt.adamw_update(T.opt.AdamWConfig(**cfg), tp,
                                    _to(T, g), ts, tscale)
        _close(tp, rp)
        _close(ts["mu"], rs["mu"])
        _close(ts["nu"], rs["nu"])
        assert int(ts["step"]) == int(rs["step"]) == i + 1
        assert ts["step"].dtype == torch.int32
    assert tp["a"] is leaf   # in place


def test_sgd_momentum_update_matches_reference():
    params = _tree(11)
    rp, tp = _to(R, params), _to(T, params)
    rs, ts = R.opt.sgd_momentum_init(rp), T.opt.sgd_momentum_init(tp)
    for i in range(3):
        g = _tree(30 + i)
        rp, rs = R.opt.sgd_momentum_update(rp, _to(R, g), rs, lr=0.05)
        tp, ts = T.opt.sgd_momentum_update(tp, _to(T, g), ts, lr=0.05)
        _close(tp, rp)
        _close(ts["mom"], rs["mom"])
    assert int(ts["step"]) == int(rs["step"]) == 3


# --------------------------------------------------------------------- #
# Gradient compression: port against reference
# --------------------------------------------------------------------- #


def test_int8_payload_and_scale_bit_exact():
    """``compress`` on seeded tensors and on exact .5 ties (max 127, so
    the scale is 1 and ``g / scale`` lands on the ties): payload and
    scale bit-exact, ties rounded half to even."""
    rng = np.random.default_rng(5)
    ties = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 126.5],
                    np.float32)
    cases = [ties] + [
        (rng.standard_normal(shape) * 10.0 ** e).astype(np.float32)
        for shape, e in (((1000,), -3), ((17, 33), 0), ((4, 5, 6), 2))]
    for g in cases:
        rq, rs = R.gc.compress(jnp.asarray(g))
        tq, ts = T.gc.compress(torch.from_numpy(g))
        assert tq.dtype == torch.int8
        np.testing.assert_array_equal(tq.numpy(), np.asarray(rq))
        assert np.float32(ts) == np.float32(rs)
        np.testing.assert_array_equal(
            T.gc.decompress(tq, ts).numpy(),
            np.asarray(R.gc.decompress(rq, rs)))
    q, _ = T.gc.compress(torch.from_numpy(ties))
    assert q.tolist() == [127, 0, 2, 2, 0, -2, -2, 4, 126]


def test_int8_error_feedback_bit_exact():
    grads = [_tree(40 + i, 1e-2) for i in range(6)]
    re_ = R.gc.init_error(_to(R, grads[0]))
    te = T.gc.init_error(_to(T, grads[0]))
    for g in grads:
        rd, re_ = R.gc.compress_grads_with_feedback(_to(R, g), re_)
        td, te = T.gc.compress_grads_with_feedback(_to(T, g), te)
        _close(td, rd, rtol=0)
        _close(te, re_, rtol=0)


@pytest.mark.parametrize("fuse", [False, True])
def test_sign_compression_bit_exact_with_equal_stats(fuse):
    """``compress_grads_sign_with_feedback`` over a seeded tree for four
    steps, and ``pum_sign_majority3``: deq, err and the majority bitmap
    bit-exact, and the PuM devices' ``EngineStats`` identical."""
    rdev = R.pum.device(width=32, fuse=fuse)
    tdev = T.pum.device(width=32, fuse=fuse, device="cpu")
    grads = [_tree(50 + i, 1e-2) for i in range(4)]
    re_ = R.gc.init_error(_to(R, grads[0]))
    te = T.gc.init_error(_to(T, grads[0]))
    for g in grads:
        rd, re_ = R.gc.compress_grads_sign_with_feedback(
            _to(R, g), re_, device=rdev, tau_factor=0.7)
        td, te = T.gc.compress_grads_sign_with_feedback(
            _to(T, g), te, device=tdev, tau_factor=0.7)
        _close(td, rd, rtol=0)
        _close(te, re_, rtol=0)
    rng = np.random.default_rng(9)
    votes = [R.gc.pack_bitmap(rng.standard_normal(4099) < 0)
             for _ in range(3)]
    np.testing.assert_array_equal(
        T.gc.pum_sign_majority3(*votes, device=tdev),
        R.gc.pum_sign_majority3(*votes, device=rdev))
    for v in votes:
        np.testing.assert_array_equal(T.gc.pack_bitmap(
            T.gc.unpack_bitmap(v, 4099)), v)
    assert tdev.stats.as_dict() == rdev.stats.as_dict()
    assert tdev.stats.latency_ns > 0


def test_sign_compression_returns_onto_the_gradients_device():
    dev = T.pum.device(width=32, device="cpu")
    g = {"w": torch.ones(70, dtype=torch.bfloat16) * -0.5}
    deq, err = T.gc.compress_grads_sign_with_feedback(
        g, T.gc.init_error(g), device=dev)
    assert deq["w"].dtype == torch.bfloat16
    assert err["w"].dtype == torch.float32
    assert torch.equal(deq["w"], g["w"]) and not err["w"].any()


# --------------------------------------------------------------------- #
# The train step: port against reference
# --------------------------------------------------------------------- #


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


@pytest.mark.parametrize("compression", [False, True])
@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mamba2-130m",
                                  "deepseek-v2-236b"])
def test_train_step_matches_reference(arch, microbatches, compression):
    """Three train steps from the reference's params and AdamW state
    (float32 smoke config; warmup 1, so steps 2 and 3 see updated
    params): every metric within 1e-5 relative of the reference's."""
    rcfg = dataclasses.replace(R.base.get_smoke_config(arch),
                               dtype="float32")
    tcfg_ = dataclasses.replace(T.base.get_smoke_config(arch),
                                dtype="float32")
    kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10,
              microbatches=microbatches, grad_compression=compression)
    rt, tt = R.base.TrainConfig(**kw), T.base.TrainConfig(**kw)
    rp, ro = R.trainer.init_train_state(rcfg, rt, jax.random.PRNGKey(0))
    tp = params_from_reference(tcfg_, jax.tree.map(np.asarray, rp),
                               device="cpu")
    to = opt_state_from_reference(tcfg_, jax.tree.map(np.asarray, ro),
                                  device="cpu")
    assert sorted(to) == sorted(ro)
    rstep = jax.jit(R.trainer.build_train_step(rcfg, rt))
    tstep = T.trainer.build_train_step(tcfg_, tt)
    data = R.data.SyntheticLM(R.data.DataConfig(
        seq_len=16, global_batch=4, vocab_size=rcfg.vocab_size))
    for step in range(3):
        batch = data.batch(step)
        rp, ro, rm = rstep(rp, ro, jax.tree.map(jnp.asarray, batch))
        tp, to, tm = tstep(tp, to, T.trainer.device_batch(batch, "cpu"))
        assert sorted(tm) == sorted(rm)
        for k in rm:
            assert _rel(float(tm[k]), float(rm[k])) <= STEP_RTOL, \
                (step, k, float(tm[k]), float(rm[k]))
        assert int(to["step"]) == int(ro["step"]) == step + 1
    if microbatches > 1:
        assert float(tm["nll"]) == float(tm["loss"])   # reference quirk


# --------------------------------------------------------------------- #
# Checkpoint format: each package restores the other's
# --------------------------------------------------------------------- #


def _state(ns, cfg, compression=True):
    tcfg = ns.base.TrainConfig(grad_compression=compression)
    return ns.init_state(cfg, tcfg)


def _flat_np(tree):
    return {"/".join(map(str, path)): _np(leaf)
            for path, leaf in tree_items(tree)}


def _ref_flat_np(tree):
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    cfg = R.base.get_smoke_config("deepseek-v2-236b")
    rp, ro = _state(R, cfg)
    ro = dict(ro, step=jnp.array(7, jnp.int32))
    rmgr = R.ckpt.CheckpointManager(str(tmp_path))
    rmgr.save(7, rp, ro, meta={"run": "ref"})
    rmgr.wait()
    tcfg = T.base.get_smoke_config("deepseek-v2-236b")
    tp, to = _state(T, tcfg)
    mgr = T.ckpt.CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 7
    p2, o2, meta = mgr.restore(7, tp, to)
    assert meta["step"] == 7 and meta["run"] == "ref"
    with open(tmp_path / "step_00000007" / "meta.json") as f:
        assert json.load(f) == meta
    want = _ref_flat_np({"params": rp, "opt": ro})
    got = _flat_np({"params": p2, "opt": o2})
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype
    assert o2["step"].dtype == torch.int32 and int(o2["step"]) == 7


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    tcfg = T.base.get_smoke_config("hymba-1.5b")
    tp, to = _state(T, tcfg)
    to["step"] += 3
    mgr = T.ckpt.CheckpointManager(str(tmp_path / "port"),
                                   async_write=False)
    mgr.save(3, tp, to, meta={"run": "port"})
    rcfg = R.base.get_smoke_config("hymba-1.5b")
    rp, ro = _state(R, rcfg)
    p2, o2, meta = R.ckpt.CheckpointManager(str(tmp_path / "port")).restore(
        3, rp, ro)
    assert meta["step"] == 3 and meta["run"] == "port"
    got = _ref_flat_np({"params": p2, "opt": o2})
    want = _flat_np({"params": tp, "opt": to})
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert int(o2["step"]) == 3
    # The two packages write the same npz names for the same state.
    ref_dir = tmp_path / "ref"
    R.ckpt.CheckpointManager(str(ref_dir), async_write=False).save(3, rp, ro)
    for name in ("params.npz", "opt_state.npz"):
        with np.load(tmp_path / "port" / "step_00000003" / name) as a, \
                np.load(ref_dir / "step_00000003" / name) as b:
            assert sorted(a.files) == sorted(b.files)


def test_checkpoint_atomic_commit_and_retention(P, tmp_path):
    """Retention keeps the newest ``keep`` steps; a ``.tmp`` directory
    (an interrupted write) is never a step; a re-save of a step replaces
    it."""
    mgr = P.ckpt.CheckpointManager(str(tmp_path), keep=2, async_write=False)
    tree = {"w": P.arr(np.arange(6.0).reshape(2, 3))}
    for step in (1, 2, 3, 4):
        mgr.save(step, tree, {"m": tree["w"]})
    assert mgr.all_steps() == [3, 4]
    os.makedirs(tmp_path / "step_00000009.tmp")
    assert mgr.latest_step() == 4
    mgr.save(4, {"w": P.arr(np.ones((2, 3)))}, {"m": tree["w"]})
    p, _, meta = mgr.restore(4, tree, {"m": tree["w"]})
    np.testing.assert_array_equal(P.np(p["w"]), np.ones((2, 3)))
    assert meta["step"] == 4 and mgr.all_steps() == [3, 4]


def test_port_save_copies_before_the_in_place_update(tmp_path):
    """On the CPU ``Tensor.numpy()`` aliases the tensor: the async save
    must hold a copy, or the next in-place step would be written."""
    mgr = T.ckpt.CheckpointManager(str(tmp_path))
    w = torch.zeros(1 << 16)
    gate = threading.Event()
    real = mgr._write
    mgr._write = lambda *a: (gate.wait(10), real(*a))
    mgr.save(1, {"w": w}, {"s": torch.zeros((), dtype=torch.int32)})
    w += 1.0
    gate.set()
    mgr.wait()
    p, _, _ = mgr.restore(1, {"w": w}, {"s": torch.zeros(
        (), dtype=torch.int32)})
    assert not p["w"].any()


# --------------------------------------------------------------------- #
# The launcher: preemption and resume on the CPU
# --------------------------------------------------------------------- #


def _launch(args, ckpt_dir):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen1.5-0.5b", "--smoke", "--log-every", "1", "--steps", "12",
         "--ckpt-every", "5", "--seq-len", "32", "--global-batch", "4",
         "--device", "cpu", "--ckpt-dir", str(ckpt_dir)] + args,
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS="1"))
    lines = {int(ln.split()[1]): ln for ln in out.stdout.splitlines()
             if ln.startswith("step ")}
    return out, lines


def _loss(line: str) -> str:
    return line.split()[3]


def test_launcher_preemption_and_resume(tmp_path):
    pre, lines = _launch(["--simulate-preemption", "7"], tmp_path / "a")
    assert pre.returncode == 42, pre.stderr
    assert "[train] simulated preemption at step 7" in pre.stdout
    assert sorted(lines) == list(range(7))
    mgr = T.ckpt.CheckpointManager(str(tmp_path / "a"))
    assert mgr.all_steps() == [5]
    res, rlines = _launch([], tmp_path / "a")
    assert res.returncode == 0, res.stderr
    assert sorted(rlines) == list(range(5, 12))
    assert "over 7 steps" in res.stdout.splitlines()[-1]
    assert mgr.latest_step() == 12
    full, flines = _launch([], tmp_path / "b")
    assert full.returncode == 0, full.stderr
    assert sorted(flines) == list(range(12))
    assert _loss(rlines[5]) == _loss(flines[5])
    assert _loss(rlines[11]) == _loss(flines[11])
