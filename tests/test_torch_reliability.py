"""The port's reliability plane against the reference, on one calibrated chip.

A map calibrated by the reference (``repro.reliability.calibrate``) is
carried into the port with ``convert.reliability_map_from_reference``, so
both packages plan, inject and vote on the same chip. Then:

* plan-only devices give ``EngineStats.as_dict()`` identical to the
  reference's, and outputs bit-exact;
* injecting devices give outputs bit-exact and every ``reliability.*``
  counter identical — the masks come from the same NumPy streams and the
  port's vote (``ops.maj_n`` threshold planes) counts the same bits — at
  widths 16 and 64, in the vote-correction, bounded-retry and
  oracle-fallback cases of ``tests/reliability/test_plane_injection.py``;
* maps saved by either package load in the other.

Sizes are the reference suite's (4 banks, n_columns 64, n_patterns 4).
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import repro.pum as rpum
from repro.core.profiles import PROFILES
from repro.reliability import (FaultInjector as RFaultInjector,
                               ReliabilityMap as RReliabilityMap,
                               majority_vote as r_majority_vote)
from repro_torch import convert
import repro_torch.pum as tpum
from repro_torch.kernels import ops
from repro_torch.kernels.plane_layout import LAYOUT32, LAYOUT64
from repro_torch.reliability import (FaultInjector, ReliabilityConfig,
                                     ReliabilityMap, ReliabilityPlane,
                                     calibrate, majority_vote)

PV_M = PROFILES["M"].process_variation
CAL = dict(n_subarrays=4, n_columns=64, n_patterns=4)


def port_map(rmap) -> ReliabilityMap:
    return convert.reliability_map_from_reference(
        mfr=rmap.mfr, seed=rmap.seed, n_subarrays=rmap.n_subarrays,
        n_columns=rmap.n_columns, configs=rmap.configs,
        success=rmap.success, flip_p=rmap.flip_p,
        bank_scale=rmap.bank_scale)


def run_kernel(dev, a, b):
    x = dev.asarray(a)
    y = dev.asarray(b)
    out = (x & y) ^ (x + y)
    lt = x < y
    t = (out * y) - x
    dev.flush()
    return out.to_numpy(), lt.to_numpy(), t.to_numpy()


def rel_counters(dev):
    c = dev.counters.as_dict()["counters"]
    return {k: v for k, v in c.items() if k.startswith("reliability.")}


def operands(width, n, seed):
    rng = np.random.default_rng(seed)
    hi = 2**64 - 1 if width == 64 else (1 << width) - 1
    return [rng.integers(0, hi, n, dtype=np.uint64, endpoint=True)
            for _ in range(2)]


def device_pair(width, *, inject, pv_scale=3.0, **policy):
    """A reference device calibrated (seeded from its config) and a port
    device on the CPU carrying the same map and policy."""
    ref = rpum.device(mfr="M", width=width, banks=4, fuse=True, seed=7)
    rmap = ref.calibrate(inject=inject, process_variation=PV_M * pv_scale,
                         **CAL, **policy)
    cfg = ReliabilityConfig(map=port_map(rmap), inject=inject, **policy)
    port = tpum.device(mfr="M", width=width, banks=4, seed=7, device="cpu",
                       reliability=cfg)
    return ref, port


# --------------------------------------------------------------------- #
# Planning: EngineStats identical


@pytest.mark.parametrize("width,target", [(16, 0.99), (32, 0.95),
                                          (64, 0.99)])
def test_plan_only_stats_identical(width, target):
    a, b = operands(width, 300, width)
    ref, port = device_pair(width, inject=False, target_success=target)
    want = run_kernel(ref, a, b)
    got = run_kernel(port, a, b)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert port.stats.as_dict() == ref.stats.as_dict()
    assert rel_counters(port) == rel_counters(ref) == {}
    for kind in ("and2", "add", "mul", "compare"):
        assert port.engine._cfg_for(kind, width, None)[:3] == \
            ref.engine._cfg_for(kind, width, None)[:3]


# --------------------------------------------------------------------- #
# Injection: outputs bit-exact, every reliability counter identical

INJECT_CASES = {
    # test_injection_corrects_and_stays_bit_exact
    "corrects": dict(flip_scale=40.0, pv_scale=5.0, steer=False),
    # test_retry_escalation_bounded_and_counted
    "max_attempts": dict(flip_scale=40.0, pv_scale=5.0, steer=False,
                         max_attempts=3),
    # test_oracle_fallback_is_last_resort_and_bit_exact
    "oracle_fallback": dict(flip_scale=10.0, pv_scale=6.0, steer=False,
                            max_attempts=2),
    "steered": dict(flip_scale=40.0, pv_scale=5.0, steer=True),
}


@pytest.mark.parametrize("case", sorted(INJECT_CASES))
@pytest.mark.parametrize("width", [16, 64])
def test_injected_flush_matches_reference(case, width):
    kw = dict(INJECT_CASES[case])
    pv_scale = kw.pop("pv_scale")
    a, b = operands(width, 512, 11)
    ref, port = device_pair(width, inject=True, pv_scale=pv_scale, **kw)
    want = run_kernel(ref, a, b)
    again = run_kernel(ref, b, a)   # a second flush: flush_idx advances
    got = run_kernel(port, a, b)
    got2 = run_kernel(port, b, a)
    for g, w in zip(got + got2, want + again):
        np.testing.assert_array_equal(g, w)
    want_c, got_c = rel_counters(ref), rel_counters(port)
    assert got_c == want_c
    assert got_c["reliability.flushes"] == 2
    if case == "oracle_fallback":
        assert got_c["reliability.oracle_fallbacks"] >= 1
    elif case != "steered":
        assert got_c["reliability.injected_bits"] > 0
        assert got_c["reliability.corrected_bits"] > 0
    assert port.stats.as_dict() == ref.stats.as_dict()


@pytest.mark.parametrize("width", [16, 64])
def test_vote_escalates_past_32_replicas(width):
    """31 votes, escalated by two per retry to 33 and 35: the vote runs at
    any replica count, as the reference's does (the MAJ-N kernel's counter
    takes up to 65535 planes). A margin of 31 makes the 31-vote round weak
    on any disagreement, so the retries are taken."""
    policy = dict(flip_scale=40.0, steer=False, votes=31, max_attempts=3,
                  min_margin=31)
    a, b = operands(width, 512, 13)
    ref, port = device_pair(width, inject=True, pv_scale=5.0, **policy)
    want = run_kernel(ref, a, b)
    got = run_kernel(port, a, b)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    want_c, got_c = rel_counters(ref), rel_counters(port)
    assert got_c == want_c
    assert got_c["reliability.retries"] >= 1
    assert got_c["reliability.votes_run"] > 31 * len(got)
    assert port.stats.as_dict() == ref.stats.as_dict()


def test_flush_span_reports_attempts(tmp_path):
    a, b = operands(16, 256, 15)
    _, port = device_pair(16, inject=True, pv_scale=5.0, flip_scale=40.0,
                          steer=False)
    path = tmp_path / "trace.json"
    with tpum.profile(port, path=str(path)):
        run_kernel(port, a, b)
    events = json.loads(path.read_text())["traceEvents"]
    dispatch = [e for e in events if e.get("name") == "flush.dispatch"]
    assert dispatch and all("attempts" in e["args"] and "fallback"
                            in e["args"] for e in dispatch)


# --------------------------------------------------------------------- #
# Vote and injector mechanics against the reference's


@pytest.mark.parametrize("width", [5, 16, 32, 48, 64])
@pytest.mark.parametrize("votes", [1, 3, 5, 7, 33, 65])
def test_majority_vote_matches_reference(width, votes):
    rng = np.random.default_rng(width * 10 + votes)
    layout = LAYOUT32 if width <= 32 else LAYOUT64
    n = 256
    clean = rng.integers(0, 2**width - 1, n, dtype=np.uint64, endpoint=True)
    reps = np.empty((votes, n), layout.np_dtype)
    for v in range(votes):
        flips = rng.random(n) < 0.4
        bits = rng.integers(0, width, n).astype(np.uint64)
        reps[v] = (clean ^ np.where(flips, np.uint64(1) << bits,
                                    np.uint64(0))).astype(layout.np_dtype)
    wire = torch.from_numpy(np.stack([layout.to_wire(r) for r in reps]))
    for mm in (1, 2, 3):
        want = r_majority_vote(reps, width, mm)
        maj, corrected, weak = majority_vote(wire, width, mm, layout)
        np.testing.assert_array_equal(layout.from_wire(maj), want[0])
        assert (corrected, weak) == want[1:]


def test_hand_built_votes():
    reps = np.array([[0b0110], [0b0010], [0b0010]], np.uint32)
    maj, corrected, weak = majority_vote(torch.from_numpy(reps.view(np.int32)),
                                         4, 2)
    assert int(maj[0]) == 0b0010 and corrected == 1 and weak == 1
    reps5 = np.array([[6], [2], [2], [2], [2]], np.uint32)
    maj, corrected, weak = majority_vote(
        torch.from_numpy(reps5.view(np.int32)), 4, 2)
    assert int(maj[0]) == 2 and corrected == 1 and weak == 0


def test_vote_runs_through_maj_n_dispatch(monkeypatch):
    seen = []
    real = ops.maj_n

    def spy(x, t):
        seen.append(t)
        return real(x, t)

    monkeypatch.setattr(ops, "maj_n", spy)
    reps = torch.randint(-2**31, 2**31 - 1, (5, 64), dtype=torch.int32)
    majority_vote(reps, 32, 2)
    # maj s >= 3; disagreement s >= 1 and not s >= 5; weak band
    # |2s - 5| < 2, i.e. s >= 2 and not s >= 4: one launch per threshold.
    assert sorted(seen) == [1, 2, 3, 4, 5]


@pytest.fixture(scope="module")
def ref_map():
    from repro.reliability import calibrate as r_calibrate
    return r_calibrate("M", banks=4, n_subarrays=4, n_columns=64,
                       n_patterns=4, seed=13, process_variation=PV_M * 4)


@pytest.mark.parametrize("steer", [True, False])
def test_fault_injector_matches_reference(ref_map, steer):
    pm = port_map(ref_map)
    idx = ref_map.config_index(3, 4)
    n = ref_map.n_columns * 3 + 7
    want = RFaultInjector(ref_map, idx, width=16, n_ops=2, steer=steer)
    got = FaultInjector(pm, idx, width=16, n_ops=2, steer=steer)
    np.testing.assert_array_equal(got.lane_probs(n), want.lane_probs(n))
    p = np.full(n, 0.3)
    for dtype in (np.uint32, np.uint64):
        m1, k1 = got.sample_mask(np.random.default_rng([1, 2]), p,
                                 np.dtype(dtype))
        m2, k2 = want.sample_mask(np.random.default_rng([1, 2]), p,
                                  np.dtype(dtype))
        np.testing.assert_array_equal(m1, m2)
        assert k1 == k2


def test_map_queries_match_reference(ref_map):
    pm = port_map(ref_map)
    for i in range(len(pm.configs)):
        assert pm.home_order(i) == ref_map.home_order(i)
        assert pm.weak_column_frac(i) == ref_map.weak_column_frac(i)
        for lvl in range(3):
            assert pm.escalated_config(i, lvl) == \
                ref_map.escalated_config(i, lvl)
    assert pm.bank_order() == ref_map.bank_order()
    assert pm.nearest_config(5, 32) == ref_map.nearest_config(5, 32)
    plan, s = pm.best_plan(3, 0.9)
    rplan, rs = ref_map.best_plan(3, 0.9)
    assert (plan.n_rg, plan.copies, s) == (rplan.n_rg, rplan.copies, rs)
    plane = ReliabilityPlane(ReliabilityConfig(map=pm), mfr="M",
                             counters=None)
    assert plane.bank_order(6) == [b for b in ref_map.bank_order()] + [4, 5]


# --------------------------------------------------------------------- #
# Persistence across packages


def test_maps_load_across_packages(tmp_path, ref_map):
    rp = tmp_path / "ref.npz"
    ref_map.save(rp)
    got = ReliabilityMap.load(rp)
    port = calibrate("M", banks=2, n_subarrays=2, n_columns=32,
                     n_patterns=4, device="cpu")
    pp = tmp_path / "port.npz"
    port.save(pp)
    back = RReliabilityMap.load(pp)
    for a, b in ((got, ref_map), (port, back)):
        assert (a.mfr, a.seed, a.n_subarrays, a.n_columns, a.configs) == \
            (b.mfr, b.seed, b.n_subarrays, b.n_columns, b.configs)
        for field in ("success", "flip_p", "bank_scale"):
            x, y = getattr(a, field), getattr(b, field)
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    with np.load(rp) as zr, np.load(pp) as zp:
        assert sorted(zr.files) == sorted(zp.files)
        assert json.loads(bytes(zr["meta"]).decode()).keys() == \
            json.loads(bytes(zp["meta"]).decode()).keys()


# --------------------------------------------------------------------- #
# Config, construction and Device plumbing


def test_reliability_config_validation():
    for bad in (dict(votes=2), dict(votes=0), dict(max_attempts=0),
                dict(min_margin=0), dict(target_success=0.0),
                dict(flip_scale=-1.0)):
        with pytest.raises(ValueError):
            ReliabilityConfig(**bad)


def test_plane_requires_matching_map(ref_map):
    pm = port_map(ref_map)
    with pytest.raises(ValueError, match="manufacturer"):
        ReliabilityPlane(ReliabilityConfig(map=pm), mfr="H", counters=None)
    with pytest.raises(ValueError, match="must be a ReliabilityMap"):
        ReliabilityPlane(ReliabilityConfig(), mfr="M", counters=None)
    with pytest.raises(TypeError):
        ReliabilityPlane(object(), mfr="M", counters=None)


def test_inject_requires_fused_device(ref_map):
    cfg = ReliabilityConfig(map=port_map(ref_map), inject=True)
    with pytest.raises(ValueError, match="fuse"):
        tpum.Device(mfr="M", banks=4, fuse=False, device="cpu",
                    reliability=cfg)
    dev = tpum.Device(mfr="M", width=16, banks=4, fuse=False, device="cpu")
    with pytest.raises(ValueError, match="fuse"):
        dev.calibrate(inject=True, **CAL)


def test_device_calibrate_save_reuse_and_as_device(tmp_path):
    p = tmp_path / "chip.npz"
    dev = tpum.device(mfr="M", width=16, banks=4, seed=7, device="cpu")
    rmap = dev.calibrate(attach=False, save=p, **CAL)
    assert dev.reliability is None
    assert rmap.n_banks == 4 and rmap.n_columns == 64
    dev2 = tpum.device(mfr="M", width=16, banks=4, seed=7, device="cpu",
                       reliability=tpum.ReliabilityConfig(map=str(p)))
    np.testing.assert_array_equal(dev2.reliability.map.flip_p, rmap.flip_p)
    again = dev.calibrate(**CAL)   # same config -> bit-identical map
    np.testing.assert_array_equal(again.flip_p, rmap.flip_p)
    assert dev.reliability is not None and not dev.reliability.inject
    wrapped = tpum.as_device(dev.engine)
    assert wrapped.config.reliability is dev.config.reliability
    assert wrapped.engine is dev.engine


def test_calibrate_clears_planning_cache():
    dev = tpum.device(mfr="M", width=16, banks=4, seed=7, device="cpu")
    before = dev.engine._cfg_for("and2", 16, None)
    dev.calibrate(process_variation=PV_M * 3, target_success=0.999, **CAL)
    after = dev.engine._cfg_for("and2", 16, None)
    rel = dev.reliability
    assert after[2] == rel.plan_success(after[0], after[1]) != before[2]
