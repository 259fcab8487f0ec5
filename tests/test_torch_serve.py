"""The port's serve path (``ServeEngine``, its PuM stop predicate and the
launcher) against the reference, on the CPU.

* ``tests/train/test_train_stack.py:231-289`` (end to end, the PuM stop
  predicate against the host loop, the slot path against a direct
  prefill/decode loop) and the 5 tests of
  ``tests/telemetry/test_serve_telemetry.py`` run through both packages
  (the ``P`` fixture; the port with ``device="cpu"``).
* Reference against port: the same float32 smoke parameters (carried over
  by ``convert.params_from_reference``) and the same seeded prompts give
  identical token streams — with ``pum_bulk`` on and off, sync and
  ``async_stop``, on a stacked-cache arch, a per-layer-cache arch and an
  SSM arch, at ``max_batch`` 1 too (the reference's batch-axis rule is
  kept) — and the stop predicate's ``EngineStats`` are identical
  (tolerance 0: integer PuM programs priced by the same cost plane).
* The stop predicate is captured once and replayed on every tick.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import io
import types

import jax
import numpy as np
import pytest
import torch

from repro_torch.convert import params_from_reference
from repro_torch.kernels import fused_program as tfp

PACKAGES = ["repro", "repro_torch"]


def _ns(name: str) -> types.SimpleNamespace:
    ns = types.SimpleNamespace(name=name)
    ns.base = importlib.import_module(f"{name}.config.base")
    ns.model = importlib.import_module(f"{name}.models.model")
    ns.serve = importlib.import_module(f"{name}.serve.engine")
    ns.Request = ns.serve.Request
    extra = {"device": "cpu"} if name == "repro_torch" else {}
    ns.Engine = lambda cfg, **kw: ns.serve.ServeEngine(cfg, **{**extra, **kw})
    if name == "repro":
        ns.init = lambda cfg, seed: ns.model.init_params(
            cfg, jax.random.PRNGKey(seed))
        ns.tokens = lambda a: jax.numpy.asarray(a)
        ns.argmax = lambda v: int(jax.numpy.argmax(v))
    else:
        ns.init = lambda cfg, seed: ns.model.init_params(cfg, seed,
                                                         device="cpu")
        ns.tokens = lambda a: torch.as_tensor(np.asarray(a, np.int64))
        ns.argmax = lambda v: int(torch.argmax(v))
    return ns


NS = {name: _ns(name) for name in PACKAGES}


@pytest.fixture(params=PACKAGES)
def P(request):
    return NS[request.param]


# --------------------------------------------------------------------- #
# tests/train/test_train_stack.py:231-289
# --------------------------------------------------------------------- #


def test_serve_engine_end_to_end(P):
    cfg = P.base.get_smoke_config("qwen1.5-0.5b")
    eng = P.Engine(cfg, max_batch=2, max_len=64, eos_id=-1)
    rng = np.random.default_rng(0)
    for rid in range(4):
        eng.submit(P.Request(rid=rid,
                             prompt=rng.integers(0, cfg.vocab_size, 8,
                                                 dtype=np.int32),
                             max_new_tokens=4))
    done = eng.run_until_drained(max_ticks=200)
    assert len(done) == 4
    for req in done:
        assert len(req.out_tokens) == 4
        assert all(0 <= t < cfg.padded_vocab for t in req.out_tokens)


def test_serve_pum_bulk_stop_mask_matches_host_path(P):
    cfg = P.base.get_smoke_config("qwen1.5-0.5b")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, 6, dtype=np.int32)
               for _ in range(3)]
    outs = []
    for pum_bulk in (True, False):
        eng = P.Engine(cfg, max_batch=2, max_len=32, eos_id=3, seed=0,
                       pum_bulk=pum_bulk)
        assert (eng.pum is not None) == pum_bulk
        for rid, p in enumerate(prompts):
            eng.submit(P.Request(rid=rid, prompt=p, max_new_tokens=5))
        done = eng.run_until_drained(max_ticks=100)
        outs.append(sorted((r.rid, tuple(r.out_tokens)) for r in done))
    assert outs[0] == outs[1]
    eng2 = P.Engine(cfg, max_batch=2, max_len=32, eos_id=3, seed=0)
    eng2.submit(P.Request(rid=0, prompt=prompts[0], max_new_tokens=2))
    eng2.run_until_drained(max_ticks=20)
    assert eng2.pum.stats.latency_ns > 0


def test_serve_engine_matches_prefill_decode(P):
    cfg = P.base.get_smoke_config("mamba2-130m")
    params = P.init(cfg, 0)
    prompt = np.arange(8, dtype=np.int32) % cfg.vocab_size
    eng = P.Engine(cfg, params=params, max_batch=2, max_len=32, eos_id=-1)
    eng.submit(P.Request(rid=0, prompt=prompt, max_new_tokens=3))
    done = eng.run_until_drained(max_ticks=50)
    logits, caches, _ = P.model.prefill(
        cfg, params, {"tokens": P.tokens(prompt)[None]}, 32)
    toks = [P.argmax(logits[0, :cfg.vocab_size])]
    pos = 8
    for _ in range(2):
        logits, caches = P.model.decode_step(
            cfg, params, caches, P.tokens([toks[-1]]), P.tokens([pos]))
        toks.append(P.argmax(logits[0, :cfg.vocab_size]))
        pos += 1
    assert done[0].out_tokens == toks


# --------------------------------------------------------------------- #
# tests/telemetry/test_serve_telemetry.py
# --------------------------------------------------------------------- #


def _prompts(P, n=3, rng_seed=1):
    cfg = P.base.get_smoke_config("qwen1.5-0.5b")
    rng = np.random.default_rng(rng_seed)
    return cfg, [rng.integers(0, cfg.vocab_size, 6, dtype=np.int32)
                 for _ in range(n)]


def _run(P, cfg, prompts, telemetry, **kw):
    eng = P.Engine(cfg, max_batch=2, max_len=32, eos_id=3, seed=0,
                   telemetry=telemetry, **kw)
    for rid, p in enumerate(prompts):
        eng.submit(P.Request(rid=rid, prompt=p, max_new_tokens=5))
    done = eng.run_until_drained(max_ticks=100)
    return eng, sorted((r.rid, tuple(r.out_tokens)) for r in done)


def test_telemetry_does_not_perturb_token_streams(P):
    cfg, prompts = _prompts(P)
    _, off = _run(P, cfg, prompts, telemetry=False)
    _, on = _run(P, cfg, prompts, telemetry=True)
    assert off == on


def test_telemetry_off_is_inert(P):
    cfg, prompts = _prompts(P, n=1)
    eng, _ = _run(P, cfg, prompts, telemetry=False)
    assert eng.tracer is None
    assert len(eng.counters) == 0


def test_tick_counters_and_slot_occupancy(P):
    cfg, prompts = _prompts(P)
    eng, outs = _run(P, cfg, prompts, telemetry=True)
    assert outs
    assert eng.counters["serve.ticks"] >= 1
    occ = eng.counters.histogram("serve.active_slots")
    assert occ["count"] == eng.counters["serve.ticks"]
    assert 1 <= occ["max"] <= 2
    lat = eng.counters.histogram("serve.stop_flush_ns")
    assert lat["count"] == eng.counters["serve.ticks"]
    assert lat["min"] >= 0


def test_tick_spans_nest_stop_predicate(P):
    cfg, prompts = _prompts(P, n=2)
    eng, _ = _run(P, cfg, prompts, telemetry=True)
    names = eng.tracer.span_names()
    assert "serve.tick" in names
    assert "serve.stop_predicate" in names
    by_name = {}
    for name, t0, t1, args in eng.tracer.events:
        by_name.setdefault(name, []).append((t0, t1, args))
    ticks = by_name["serve.tick"]
    for t0, t1, args in by_name["serve.stop_predicate"]:
        assert any(tt0 <= t0 and t1 <= tt1 for tt0, tt1, _ in ticks)
        assert args["path"] in ("pum", "host")
    assert all(1 <= a["active_slots"] <= 2 for _, _, a in ticks)


def test_pum_engine_tracer_attached_when_telemetry_on(P):
    cfg, prompts = _prompts(P, n=1)
    eng, _ = _run(P, cfg, prompts, telemetry=True)
    if eng.pum is not None:
        assert eng.pum.engine.tracer is eng.tracer


def test_telemetry_counters_and_spans_equal_across_packages():
    """The same counters with the same counts; the port's spans are the
    reference's plus its own ``serve.admit`` and ``serve.decode``, each
    nested in a tick."""
    got = {}
    cfgs = _f32_cfgs("qwen1.5-0.5b")
    rp = NS["repro"].init(cfgs[0], 0)
    params = {"repro": rp, "repro_torch": params_from_reference(
        cfgs[1], jax.tree.map(np.asarray, rp), device="cpu")}
    for name, cfg in zip(PACKAGES, cfgs):
        P = NS[name]
        _, prompts = _prompts(P)
        eng, outs = _run(P, cfg, prompts, telemetry=True,
                         params=params[name])
        counts = {"serve.ticks": eng.counters["serve.ticks"]}
        for h in ("serve.active_slots", "serve.stop_flush_ns"):
            counts[h] = eng.counters.histogram(h)["count"]
        occ = eng.counters.histogram("serve.active_slots")
        got[name] = (outs, counts, (occ["min"], occ["max"]),
                     set(eng.tracer.span_names()), eng)
    r, t = got["repro"], got["repro_torch"]
    assert r[:3] == t[:3]
    serve_spans = {n for n in t[3] if n.startswith("serve.")}
    assert serve_spans == {n for n in r[3] if n.startswith("serve.")} \
        | {"serve.admit", "serve.decode"}
    events = t[4].tracer.events
    ticks = [(a, b) for n, a, b, _ in events if n == "serve.tick"]
    for n, a, b, _ in events:
        if n in ("serve.admit", "serve.decode"):
            assert any(t0 <= a and b <= t1 for t0, t1 in ticks)


# --------------------------------------------------------------------- #
# Reference against port: identical token streams
# --------------------------------------------------------------------- #


def _f32_cfgs(arch):
    return tuple(dataclasses.replace(NS[n].base.get_smoke_config(arch),
                                     dtype="float32") for n in PACKAGES)


def _streams(P, cfg, params, prompts, max_new, **kw):
    eng = P.Engine(cfg, params=params, **kw)
    for rid, (p, m) in enumerate(zip(prompts, max_new)):
        eng.submit(P.Request(rid=rid, prompt=p, max_new_tokens=m))
    done = eng.run_until_drained(max_ticks=200)
    stats = eng.pum.stats.as_dict() if eng.pum is not None else None
    return sorted((r.rid, tuple(r.out_tokens)) for r in done), stats


@pytest.mark.parametrize("arch,max_batch", [
    ("qwen1.5-0.5b", 2), ("qwen1.5-0.5b", 1), ("hymba-1.5b", 3),
    ("mamba2-130m", 2), ("deepseek-v2-236b", 2)])
def test_token_streams_equal_reference(arch, max_batch):
    rcfg, tcfg = _f32_cfgs(arch)
    rp = NS["repro"].init(rcfg, 0)
    tp = params_from_reference(tcfg, jax.tree.map(np.asarray, rp),
                               device="cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, rcfg.vocab_size, int(n), dtype=np.int32)
               for n in (6, 9, 5, 7)]
    max_new = [5, 3, 6, 4]
    eos = int(rng.integers(0, rcfg.vocab_size))
    kw = dict(max_batch=max_batch, max_len=24, eos_id=eos)
    want, want_stats = _streams(NS["repro"], rcfg, rp, prompts, max_new,
                                **kw)
    modes = [dict(pum_bulk=True), dict(pum_bulk=True, async_stop=True),
             dict(pum_bulk=False)]
    for mode in modes:
        got, stats = _streams(NS["repro_torch"], tcfg, tp, prompts, max_new,
                              **kw, **mode)
        assert got == want, mode
        if mode == dict(pum_bulk=True):
            assert stats == want_stats


def test_stop_predicate_is_captured_once_and_replayed():
    P = NS["repro_torch"]
    cfg = P.base.get_smoke_config("qwen1.5-0.5b")
    before = tfp._cached_pipeline.cache_info()
    eng, _ = _run(P, cfg, _prompts(P)[1], telemetry=True)
    prog = eng._stop_prog
    # The warm-up call at construction records; every tick replays.
    assert prog.n_records == 1
    assert prog.n_replays == eng.counters["serve.ticks"]
    events = eng.tracer.events
    # Steady ticks record nothing: no flush.record span inside a tick.
    assert not [n for n, *_ in events if n == "flush.record"]
    assert tfp._cached_pipeline.cache_info().currsize <= before.currsize + 1
    eng.close()


def test_engine_places_model_caches_and_pum_on_its_device():
    P = NS["repro_torch"]
    cfg = P.base.get_smoke_config("qwen3-1.7b")
    eng = P.Engine(cfg, max_batch=2, max_len=16, eos_id=-1)
    assert eng.pum.engine.device == torch.device("cpu")
    leaves = [eng.params["embed"]["embedding"],
              eng.caches["stack"]["k"]]
    assert all(t.device.type == "cpu" for t in leaves)
    assert eng.caches["stack"]["k"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="async_stop requires"):
        P.Engine(cfg, pum_bulk=False, async_stop=True)


def test_launcher_prints_the_reference_line():
    from repro_torch.launch import serve as tserve
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = tserve.main(["--arch", "qwen1.5-0.5b", "--smoke", "--requests",
                          "3", "--max-new", "4", "--max-batch", "2",
                          "--prompt-len", "6", "--device", "cpu"])
    assert rc == 0
    line = out.getvalue().strip()
    assert line.startswith("[serve] qwen1.5-0.5b: 3 requests, 12 tokens, ")
    assert "tok/s, TTFT mean" in line and line.endswith(" ms")


def test_max_batch_1_stacked_cache_write_matches_reference_fault():
    """A reference fault the port keeps for parity: with ``max_batch=1``
    no axis of a stacked ``[L, 1, ...]`` cache differs from the prefill's,
    so ``_admit`` falls back to axis 0 and writes only layer 0's prefill
    cache. On a stacked-cache arch (qwen) the engine's tokens after the
    first then differ from a direct prefill/decode loop, identically in
    both packages; a per-layer-cache arch (hymba) is unaffected."""
    for arch, broken in (("qwen1.5-0.5b", True), ("hymba-1.5b", False)):
        rcfg, tcfg = _f32_cfgs(arch)
        rp = NS["repro"].init(rcfg, 0)
        tp = params_from_reference(tcfg, jax.tree.map(np.asarray, rp),
                               device="cpu")
        prompt = np.arange(8, dtype=np.int32) + 5
        streams = []
        for name, cfg, params in (("repro", rcfg, rp),
                                  ("repro_torch", tcfg, tp)):
            P = NS[name]
            eng = P.Engine(cfg, params=params, max_batch=1, max_len=32,
                           eos_id=-1)
            eng.submit(P.Request(rid=0, prompt=prompt, max_new_tokens=4))
            streams.append(eng.run_until_drained()[0].out_tokens)
        P = NS["repro_torch"]
        logits, caches, _ = P.model.prefill(
            tcfg, tp, {"tokens": P.tokens(prompt)[None]}, 32)
        direct = [P.argmax(logits[0, :tcfg.vocab_size])]
        for i in range(3):
            logits, caches = P.model.decode_step(
                tcfg, tp, caches, P.tokens([direct[-1]]), P.tokens([8 + i]))
            direct.append(P.argmax(logits[0, :tcfg.vocab_size]))
        assert streams[0] == streams[1]
        assert streams[1][0] == direct[0]
        assert (streams[1] != direct) == broken, (arch, streams, direct)
