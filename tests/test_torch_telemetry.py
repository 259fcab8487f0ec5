"""The assertions of ``tests/telemetry/`` through both packages, on the CPU.

``test_counters.py`` (``CounterBank`` semantics, the hand-scheduled
two-bank trace, real controller traces), ``test_invariance.py``
(``profile`` perturbs no result, no ``EngineStats`` and no scheduled
trace, with and without ``controller="auto"``) and
``test_tracer_profile.py`` (tracer spans, Chrome export, the flush-phase
coverage and pipeline-cache counters of ``pum.profile``) run on
``repro.pum`` and on ``repro_torch.pum`` devices with ``device="cpu"``;
wherever both give numbers they are held equal (tolerance 0). The
autotuner's profiles are read from exactly these counters.
``test_serve_telemetry.py`` waits for the LM slice and
``test_bench_compare.py`` tests benchmark tooling, not the port.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import types

import numpy as np
import pytest

PACKAGES = ["repro", "repro_torch"]
FLUSH_PHASES = ["flush.record", "flush.optimize", "flush.leaf_upload",
                "flush.compile", "flush.dispatch", "flush.materialize"]


def _ns(name: str) -> types.SimpleNamespace:
    ns = types.SimpleNamespace(name=name)
    ns.pum = importlib.import_module(f"{name}.pum")
    ns.tel = importlib.import_module(f"{name}.telemetry")
    ns.ctrl = importlib.import_module(f"{name}.controller")
    ns.cmds = importlib.import_module(f"{name}.core.commands")
    ns.CostModel = importlib.import_module(
        f"{name}.core.cost_model").CostModel
    ns.T = importlib.import_module(f"{name}.core.timing").DDR4_2400
    ns.fused = importlib.import_module(f"{name}.kernels.fused_program")
    extra = {"device": "cpu"} if name == "repro_torch" else {}
    ns.device = lambda **kw: ns.pum.device(**{**extra, **kw})
    return ns


NS = {name: _ns(name) for name in PACKAGES}


@pytest.fixture(params=PACKAGES)
def P(request):
    return NS[request.param]


# --------------------------------------------------------------------- #
# test_counters.py: CounterBank
# --------------------------------------------------------------------- #


def test_counterbank_inc_get_contains(P):
    b = P.tel.CounterBank()
    assert b.get("x") == 0 and "x" not in b
    b.inc("x")
    b.inc("x", 2.5)
    assert b["x"] == 3.5 and "x" in b and len(b) == 1


def test_counterbank_histogram_log2_buckets(P):
    b = P.tel.CounterBank()
    for v in (0, 1, 2, 3, 4, 100):
        b.observe("lat", v)
    h = b.histogram("lat")
    assert h["count"] == 6
    assert h["total"] == 110
    assert h["min"] == 0 and h["max"] == 100
    assert h["mean"] == pytest.approx(110 / 6)
    assert h["buckets"] == {0: 2, 1: 1, 2: 2, 7: 1}


def test_counterbank_merge(P):
    a, b = P.tel.CounterBank(), P.tel.CounterBank()
    a.inc("n", 1)
    b.inc("n", 2)
    b.inc("m", 5)
    a.observe("h", 3)
    b.observe("h", 100)
    a.merge(b)
    assert a["n"] == 3 and a["m"] == 5
    h = a.histogram("h")
    assert h["count"] == 2 and h["min"] == 3 and h["max"] == 100


def test_counterbank_as_dict_json_shape(P):
    b = P.tel.CounterBank()
    b.inc("z")
    b.inc("a", 2)
    b.observe("lat_ns", 7)
    d = b.as_dict()
    assert list(d["counters"]) == ["a", "z"]
    json.dumps(d)
    assert "CounterBank(" in repr(b)


# --------------------------------------------------------------------- #
# test_counters.py: the hand-computable trace
# --------------------------------------------------------------------- #


def _grid(P):
    return dataclasses.replace(P.T, tck=1.0, tbl=2.0, trrd_s=4.0,
                               tfaw=30.0)


def _hand_trace(P):
    Cmd, Op = P.cmds.Cmd, P.cmds.Op
    ev = [
        (Cmd(Op.ACT, 0, 1), 0.0), (Cmd(Op.ACT, 1, 2), 4.0),
        (Cmd(Op.ACT, 2, 3), 8.0), (Cmd(Op.ACT, 3, 4), 12.0),
        (Cmd(Op.ACT, 4, 5), 30.0), (Cmd(Op.RD, 0, 1), 31.0),
        (Cmd(Op.RD, 0, 1), 33.0), (Cmd(Op.PRE, 0, -1), 40.0),
        (Cmd(Op.ACT, 0, 9), 44.0), (Cmd(Op.WR, 0, 9), 48.0),
    ]
    return P.cmds.ScheduleResult(
        total_ns=48.0, energy_j=7e-9, n_acts=6, n_pres=1, n_rdwr=3,
        issue_times=[t for _, t in ev], cmds=[c for c, _ in ev])


def test_hand_trace_command_counts_and_bus_utilization(P):
    c = P.tel.derive_controller_counters(_hand_trace(P), _grid(P))
    assert c["cmd.act"] == 6 and c["cmd.pre"] == 1 and c["cmd.rdwr"] == 3
    assert c["cmd.total"] == 10
    assert c["wall_ns"] == 48.0
    assert c["cmd_bus_busy_ns"] == 10.0
    assert c["cmd_bus_utilization"] == pytest.approx(10 / 48)
    assert c["data_bus_busy_ns"] == 6.0
    assert c["data_bus_utilization"] == pytest.approx(6 / 48)
    assert c["energy_j"] == pytest.approx(7e-9)


def test_hand_trace_stall_attribution(P):
    c = P.tel.derive_controller_counters(_hand_trace(P), _grid(P))
    assert c["stall.trrd_ns"] == pytest.approx(4 + 8 + 12 + 16)
    assert c["stall.tfaw_ns"] == pytest.approx(14.0)


def test_hand_trace_row_classification(P):
    c = P.tel.derive_controller_counters(_hand_trace(P), _grid(P))
    assert c["row.miss"] == 1 and c["row.hit"] == 1
    assert c["row.conflict"] == 1
    assert c["bank0.row_miss"] == 1 and c["bank0.row_hit"] == 1
    assert c["bank0.row_conflict"] == 1


def test_hand_trace_counters_equal_across_packages():
    r, t = NS["repro"], NS["repro_torch"]
    assert (t.tel.derive_controller_counters(_hand_trace(t), _grid(t))
            .as_dict() == r.tel.derive_controller_counters(
                _hand_trace(r), _grid(r)).as_dict())


def test_same_row_reopen_is_miss_not_conflict(P):
    Cmd, Op = P.cmds.Cmd, P.cmds.Op
    ev = [(Cmd(Op.ACT, 0, 7), 0.0), (Cmd(Op.RD, 0, 7), 14.0),
          (Cmd(Op.PRE, 0, -1), 22.0), (Cmd(Op.ACT, 0, 7), 36.0),
          (Cmd(Op.RD, 0, 7), 50.0)]
    r = P.cmds.ScheduleResult(total_ns=50.0, energy_j=0.0, n_acts=2,
                              n_pres=1, n_rdwr=2,
                              issue_times=[t for _, t in ev],
                              cmds=[c for c, _ in ev])
    c = P.tel.derive_controller_counters(r, _grid(P))
    assert c["row.miss"] == 2
    assert c.get("row.conflict", 0) == 0


def test_empty_trace(P):
    r = P.cmds.ScheduleResult(total_ns=0.0, energy_j=0.0, n_acts=0,
                              n_pres=0, n_rdwr=0, issue_times=[], cmds=[])
    c = P.tel.derive_controller_counters(r, _grid(P))
    assert c["cmd.total"] == 0 and c["wall_ns"] == 0
    assert "cmd_bus_utilization" not in c


# --------------------------------------------------------------------- #
# test_counters.py: real controller traces
# --------------------------------------------------------------------- #


def _maj_programs(P, n_ops=8, banks=4):
    unit = P.CostModel(row_bits=65536).maj_unit_programs(3, 8)
    return [P.ctrl.retarget_program(p, i % banks)
            for i in range(n_ops) for p in unit]


def test_controller_trace_counters_match_mux_accounting(P):
    tr = P.ctrl.MemoryController(n_banks=4).schedule(_maj_programs(P))
    c = tr.counters()
    assert c["cmd.act"] == tr.n_acts and c["cmd.pre"] == tr.n_pres
    assert c["cmd.rdwr"] == tr.n_rdwr
    assert c["wall_ns"] == pytest.approx(tr.total_ns)
    assert c["energy_j"] == pytest.approx(tr.energy_j)
    assert c["refresh.n"] == tr.n_refreshes
    assert c["refresh.stall_ns"] == pytest.approx(tr.refresh_stall_ns)
    assert 0 < c["cmd_bus_utilization"] < 1


def test_sequential_scheduler_counters(P):
    flat = [c for p in _maj_programs(P, 4, 1) for c in p]
    res = P.cmds.CommandScheduler(P.T).schedule(flat)
    c = res.counters()
    assert c["cmd.act"] == res.n_acts
    assert c["cmd.total"] == res.n_acts + res.n_pres + res.n_rdwr


def test_derivation_is_pure_and_idempotent(P):
    tr = P.ctrl.MemoryController(n_banks=4).schedule(_maj_programs(P))
    before = (list(tr.cmds), list(tr.issue_times))
    c1 = tr.counters().as_dict()
    assert c1 == tr.counters().as_dict()
    assert (list(tr.cmds), list(tr.issue_times)) == before


def test_controller_trace_counters_equal_across_packages():
    r, t = NS["repro"], NS["repro_torch"]
    want = r.ctrl.MemoryController(n_banks=4).schedule(
        _maj_programs(r)).counters().as_dict()
    got = t.ctrl.MemoryController(n_banks=4).schedule(
        _maj_programs(t)).counters().as_dict()
    assert got == want


# --------------------------------------------------------------------- #
# test_invariance.py
# --------------------------------------------------------------------- #


def _program(dev, a, b):
    x = dev.asarray(a)
    t = (x + b) * x
    t = t ^ b
    t = t & x
    q, r = divmod(t, (x | np.uint64(1)))
    return (q + r).to_numpy()


def _run(P, width, fuse, controller, profiled, a, b):
    dev = P.device(width=width, fuse=fuse, controller=controller)
    if profiled:
        with P.pum.profile(dev) as tr:
            out = _program(dev, a, b)
        assert tr.events or not fuse
    else:
        out = _program(dev, a, b)
    return out, dev.stats


@pytest.mark.parametrize("width", [8, 32, 64])
@pytest.mark.parametrize("fuse", [False, True])
def test_profile_does_not_perturb_results_or_stats(width, fuse):
    rng = np.random.default_rng(width)
    a = rng.integers(0, 1 << min(width, 63), 300, dtype=np.uint64)
    b = rng.integers(1, 1 << min(width, 63), 300, dtype=np.uint64)
    runs = {(name, prof): _run(NS[name], width, fuse, None, prof, a, b)
            for name in PACKAGES for prof in (False, True)}
    want, want_stats = runs[("repro", False)]
    for out, stats in runs.values():
        np.testing.assert_array_equal(out, want)
        assert stats.as_dict() == want_stats.as_dict()


def test_profile_invariance_with_controller_auto():
    rng = np.random.default_rng(5)
    a = rng.integers(0, 1 << 16, 200, dtype=np.uint64)
    b = rng.integers(1, 1 << 16, 200, dtype=np.uint64)
    runs = [_run(NS[name], 16, True, "auto", prof, a, b)
            for name in PACKAGES for prof in (False, True)]
    want, want_stats = runs[0]
    assert want_stats.refresh_stall_ns > 0
    for out, stats in runs:
        np.testing.assert_array_equal(out, want)
        assert stats.as_dict() == want_stats.as_dict()


def test_counters_not_populated_without_tracer(P):
    dev = P.device(width=16, fuse=True)
    _program(dev, np.arange(64, dtype=np.uint64),
             np.arange(64, dtype=np.uint64) + 1)
    assert len(dev.counters) == 0
    assert dev.engine.tracer is None


def test_schedule_identical_with_and_without_derivation(P):
    progs = _maj_programs(P)
    tr1 = P.ctrl.MemoryController(n_banks=4).schedule(progs)
    tr1.counters()
    tr2 = P.ctrl.MemoryController(n_banks=4).schedule(progs)
    assert tr1.cmds == tr2.cmds
    assert tr1.issue_times == tr2.issue_times
    assert tr1.total_ns == tr2.total_ns and tr1.energy_j == tr2.energy_j


def test_profile_restores_prior_tracer_and_flushes(P):
    dev = P.device(width=16, fuse=True)
    a = np.arange(32, dtype=np.uint64)
    with P.pum.profile(dev) as tr:
        pending = dev.asarray(a) + 1
    assert dev.engine.tracer is None
    np.testing.assert_array_equal(pending.to_numpy(), a + 1)
    assert any(n == "flush.dispatch" for n in tr.span_names())


# --------------------------------------------------------------------- #
# test_tracer_profile.py
# --------------------------------------------------------------------- #


def test_span_records_duration_and_args(P):
    tr = P.tel.Tracer()
    with tr.span("work", n=3) as sp:
        sp.args["extra"] = "late"
    (name, t0, t1, args), = tr.events
    assert name == "work" and t1 >= t0
    assert args == {"n": 3, "extra": "late"}
    assert sp.dur_ns == t1 - t0


def test_null_tracer_is_inert(P):
    with P.tel.NULL_TRACER.span("x", a=1) as sp:
        sp.args["y"] = 2
    assert sp.dur_ns == 0 and sp.args == {}
    P.tel.NULL_TRACER.instant("e")
    P.tel.NULL_TRACER.add_span("s", 0, 5)


def test_chrome_export_shape(P, tmp_path):
    tr = P.tel.Tracer()
    with tr.span("alpha", k="v"):
        pass
    tr.instant("tick")
    path = tmp_path / "trace.json"
    tr.export(str(path))
    doc = json.loads(path.read_text())
    assert doc["displayTimeUnit"] == "ms"
    evs = doc["traceEvents"]
    complete = [e for e in evs if e["ph"] == "X"]
    instants = [e for e in evs if e["ph"] == "i"]
    assert [e["name"] for e in complete] == ["alpha"]
    assert complete[0]["args"] == {"k": "v"}
    assert complete[0]["dur"] >= 0
    assert [e["name"] for e in instants] == ["tick"]


def _work(dev, n=128):
    x = dev.asarray(np.arange(n, dtype=np.uint64))
    return ((x + 3) * x // (x + 1)).to_numpy()


def test_profile_covers_all_flush_phases(P, tmp_path):
    dev = P.device(width=16, fuse=True)
    path = tmp_path / "trace.json"
    with P.pum.profile(dev, path=str(path)) as tr:
        _work(dev)
    names = tr.span_names()
    for phase in FLUSH_PHASES:
        assert phase in names, f"missing span {phase} in {names}"
    doc = json.loads(path.read_text())
    assert set(FLUSH_PHASES) <= {e["name"] for e in doc["traceEvents"]}
    counter_evs = [e for e in doc["traceEvents"] if e["name"] == "counters"]
    assert len(counter_evs) == 1
    assert counter_evs[0]["args"]["counters"]["engine.flushes"] >= 1


def test_profile_cache_miss_then_hit(P):
    P.fused._cached_pipeline.cache_clear()
    dev = P.device(width=16, fuse=True)
    with P.pum.profile(dev):
        _work(dev)
        dev.flush()
        _work(dev)
    assert dev.counters["engine.pipeline_cache.miss"] >= 1
    assert dev.counters["engine.pipeline_cache.hit"] >= 1


def test_profile_counts_recorded_ops_and_autoflush(P):
    dev = P.device(width=16, fuse=True, flush_threshold=4)
    with P.pum.profile(dev):
        x = dev.asarray(np.arange(32, dtype=np.uint64))
        for _ in range(6):
            x = x + 1
        x.to_numpy()
    assert dev.counters["engine.ops_recorded"] >= 6
    assert dev.counters["engine.op.add"] >= 6
    assert dev.counters["engine.autoflush.ops"] >= 1
    assert dev.counters["engine.flushes"] >= 2


def test_flush_span_args_carry_graph_shape(P):
    dev = P.device(width=16, fuse=True)
    with P.pum.profile(dev) as tr:
        _work(dev, n=64)
    by_name = {name: args for name, _, _, args in tr.events}
    assert by_name["flush.optimize"]["n_ops_in"] >= 1
    assert by_name["flush.optimize"]["n_ops_out"] >= 1
    assert by_name["flush.dispatch"]["n_lanes"] == 64
    assert by_name["flush.compile"]["cache"] in ("hit", "miss")


def _engine_counters(name, flush_threshold=None):
    """A profiled mixed workload's engine counters (pipeline caches
    cleared first, so hits and misses do not depend on earlier tests)."""
    P = NS[name]
    P.fused._cached_pipeline.cache_clear()
    dev = P.device(width=16, fuse=True, flush_threshold=flush_threshold)
    rng = np.random.default_rng(3)
    with P.pum.profile(dev):
        for _ in range(2):
            _work(dev)
        x = dev.asarray(rng.integers(0, 1 << 16, 500, dtype=np.uint64))
        for _ in range(6):
            x = (x + 1) ^ x
        x.to_numpy()
        words = rng.integers(0, 2**64, 256, dtype=np.uint64)
        (dev.asarray(words) & words[::-1].copy()).popcount(
            width=64).to_numpy()
    return dev.counters.as_dict()


@pytest.mark.parametrize("flush_threshold", [None, 4])
def test_engine_counters_equal_across_packages(flush_threshold):
    """The counter dict the autotuner profiles from: every ``engine.*``
    counter and histogram equal the reference's on the same workload."""
    want = _engine_counters("repro", flush_threshold)
    got = _engine_counters("repro_torch", flush_threshold)
    for key in ("engine.ops_recorded", "engine.flushes",
                "engine.pipeline_cache.miss", "engine.raw_ops",
                "engine.leaf_bytes_staged", "engine.leaf_cache.misses"):
        assert key in got["counters"], key
    assert got == want
