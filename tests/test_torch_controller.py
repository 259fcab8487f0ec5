"""The port's bank-parallel controller against the reference.

Every assertion of ``tests/controller/test_controller.py`` and
``tests/controller/test_crossbar.py`` runs through both packages (the
``P`` fixture is parametrised over ``repro`` and ``repro_torch``). On top
of that the port is held to the reference exactly (tolerance 0):

* the committed golden trace (``tests/controller/golden_costs.json``,
  key ``schedule``): event digest, ``total_ns``, ``energy_j`` and
  ``n_refreshes``, directly and through a single-port crossbar at
  lookaheads 1, 4 and 8;
* seeded random program streams through ``schedule``, ``schedule_batch``,
  ``schedule_concurrent`` and ``batch_cost``: the same event digest and
  the same floats;
* ``derive_controller_counters``, ``derive_port_counters`` and
  ``check_timing_invariants``: the same dicts and verdicts on the same
  workloads, the corrupted trace of the negative control included.
"""

from __future__ import annotations

import copy
import hashlib
import importlib
import json
import pathlib
import types

import numpy as np
import pytest

PKGS = ("repro", "repro_torch")
FIXTURE = pathlib.Path(__file__).parent / "controller" / "golden_costs.json"


def _ns(name: str) -> types.SimpleNamespace:
    ns = types.SimpleNamespace(name=name)
    ns.ctrl = importlib.import_module(f"{name}.controller")
    ns.cmds = importlib.import_module(f"{name}.core.commands")
    ns.CostModel = importlib.import_module(f"{name}.core.cost_model").CostModel
    ns.T = importlib.import_module(f"{name}.core.timing").DDR4_2400
    ns.tel = importlib.import_module(f"{name}.telemetry")
    engine_cls = importlib.import_module(f"{name}.core.engine").PulsarEngine
    if name == "repro_torch":
        ns.Engine = lambda **kw: engine_cls(device="cpu", **kw)
    else:
        ns.Engine = engine_cls
    return ns


_NS = {name: _ns(name) for name in PKGS}


@pytest.fixture(params=PKGS)
def P(request):
    return _NS[request.param]


def all_programs(P):
    cmds, T = P.cmds, P.T
    return {
        "apa": lambda b: cmds.prog_apa_charge_share(b, 0, 1, T),
        "aap": lambda b: cmds.prog_aap_multi_row_init(b, 0, 1, T),
        "bulk_write": lambda b: cmds.prog_bulk_write(b, 0, 1, 8, T),
        "write_row": lambda b: cmds.prog_write_row(b, 5, 8, T),
        "read_row": lambda b: cmds.prog_read_row(b, 5, 8, T),
        "frac": lambda b: cmds.prog_frac(b, 3, T),
    }


def digest(tr) -> str:
    """The golden fixture's trace digest (package-independent)."""
    lines = [f"{c.op.name},{c.bank},{c.row},{c.min_gap!r},{t!r}"
             for c, t in zip(tr.cmds, tr.issue_times)]
    return hashlib.sha256("\n".join(lines).encode()).hexdigest()


def unit_programs(P, n_banks=8):
    """One MAJ unit program per bank — the bank-parallelism workload (and
    the golden fixture's canonical workload at 8 banks)."""
    unit = P.CostModel(row_bits=65536).maj_unit_programs(3, 8)
    return [P.ctrl.retarget_program(p, b) for b in range(n_banks)
            for p in unit]


def seeded_requests(P, rng, n_ports, n_banks=16, n_req=30):
    """Random per-port request streams: a mix of accesses and programs."""
    streams = []
    for _ in range(n_ports):
        reqs = []
        for _ in range(n_req):
            bank = int(rng.integers(n_banks))
            if rng.random() < 0.3:
                reqs.append(("prog", P.cmds.prog_apa_charge_share(
                    bank, 0, 1, P.T)))
            else:
                reqs.append(("acc", bank, int(rng.integers(8)),
                             bool(rng.random() < 0.3)))
        streams.append(reqs)
    return streams


def submit_all(xb, streams):
    for p, reqs in enumerate(streams):
        for r in reqs:
            if r[0] == "prog":
                xb.port(p).submit([r[1]])
            else:
                xb.port(p).submit_access(r[1], r[2], write=r[3])


# --------------------------------------------------------------------- #
# tests/controller/test_controller.py, through both packages
# --------------------------------------------------------------------- #


def test_bank_machine_row_hit_miss_transitions(P):
    Op = P.cmds.Op
    bm = P.ctrl.BankMachine(0, P.T)
    bm.enqueue_access(5)                  # idle -> ACT + RD
    bm.enqueue_access(5)                  # hit  -> RD only
    bm.enqueue_access(9)                  # miss -> PRE + ACT + RD
    ops = [q.cmd.op for q in bm.queue]
    assert ops == [Op.ACT, Op.RD, Op.RD, Op.PRE, Op.ACT, Op.RD]
    assert bm.state is P.ctrl.BankState.IDLE
    t = 0.0
    for _ in range(2):
        t = max(t + 1, bm.earliest_issue())
        bm.issue(t)
    assert bm.state is P.ctrl.BankState.ACTIVE and bm.open_row == 5
    for _ in range(2):                    # hit RD + the PRE
        t = max(t + 1, bm.earliest_issue())
        bm.issue(t)
    assert bm.state is P.ctrl.BankState.IDLE and bm.open_row is None


def test_bank_machine_closed_page_auto_precharges(P):
    Op = P.cmds.Op
    bm = P.ctrl.BankMachine(0, P.T, open_page=False)
    bm.enqueue_access(5)
    assert [q.cmd.op for q in bm.queue] == [Op.ACT, Op.RD, Op.PRE]
    bm.enqueue_access(5)                  # closed page: never a hit
    assert [q.cmd.op for q in bm.queue][3:] == [Op.ACT, Op.RD, Op.PRE]


def test_bank_machine_sequence_boundaries(P):
    bm = P.ctrl.BankMachine(2, P.T)
    bm.enqueue_program(P.cmds.prog_apa_charge_share(2, 0, 1, P.T))
    bm.enqueue_program(P.cmds.prog_frac(2, 3, P.T))
    starts = [q.seq_start for q in bm.queue]
    assert starts == [True, False, False, False, False, True, False, False]
    assert len({q.seq_id for q in bm.queue}) == 2


@pytest.mark.parametrize("name", ["aap", "apa", "bulk_write", "frac",
                                  "read_row", "write_row"])
def test_single_bank_matches_legacy_scheduler(P, name):
    prog = all_programs(P)[name](0)
    legacy = P.cmds.CommandScheduler(P.T).schedule(prog)
    ctrl = P.ctrl.MemoryController(n_banks=16).schedule(prog)
    assert ctrl.total_ns == pytest.approx(legacy.total_ns, abs=1.0)
    for (c, t_ctrl), t_leg in zip(ctrl.events, legacy.issue_times):
        assert t_ctrl == pytest.approx(t_leg, abs=1.0)
    assert ctrl.n_acts == legacy.n_acts
    assert ctrl.energy_j == pytest.approx(legacy.energy_j)


def test_maj_unit_programs_match_closed_form_cost(P):
    cm = P.CostModel()
    for m, n_rg in [(3, 4), (3, 8), (5, 8), (5, 16)]:
        unit = cm.maj_unit_programs(m, n_rg)
        sched = P.ctrl.MemoryController(n_banks=1).schedule_batch(
            unit, 1, refresh=False).total_ns
        assert sched == pytest.approx(cm.maj_op(m, n_rg).latency_ns,
                                      abs=1e-6)


def test_schedule_result_events_are_auditable(P):
    prog = P.cmds.prog_bulk_write(0, 0, 1, 4, P.T)
    res = P.cmds.CommandScheduler(P.T).schedule(prog)
    assert len(res.cmds) == len(res.issue_times) == len(prog)
    assert [c.tag for c, _ in res.events] == [c.tag for c in prog]
    multi = [P.ctrl.retarget_program(prog, b) for b in range(4)]
    tr = P.ctrl.MemoryController(n_banks=4).schedule(multi)
    assert len(tr.events) == 4 * len(prog)
    times = [t for _, t in tr.events]
    assert times == sorted(times)
    by_bank = {b: [t for c, t in tr.events if c.bank == b] for b in range(4)}
    assert all(len(v) == len(prog) for v in by_bank.values())


def test_multiplexer_enforces_trrd_and_tfaw(P):
    Cmd, Op, T = P.cmds.Cmd, P.cmds.Op, P.T
    progs = [[Cmd(Op.ACT, b, 0, 0.0, f"act{b}")] for b in range(8)]
    tr = P.ctrl.MemoryController(n_banks=8).schedule(progs)
    acts = sorted(t for c, t in tr.events if c.op is Op.ACT)
    assert len(acts) == 8
    for a, b in zip(acts, acts[1:]):
        assert b - a >= T.trrd_s - 1e-9
    for i in range(len(acts) - 4):
        assert acts[i + 4] - acts[i] >= T.tfaw - 1e-9


def test_multiplexer_overlaps_banks_but_not_fully(P):
    apa = all_programs(P)["apa"]
    single = P.cmds.CommandScheduler(P.T).schedule(apa(0))
    progs = [apa(b) for b in range(8)]
    flat = [c for p in progs for c in p]
    seq = P.cmds.CommandScheduler(P.T).schedule(flat)
    par = P.ctrl.MemoryController(n_banks=8).schedule(progs)
    assert par.total_ns < seq.total_ns          # strict overlap win
    assert par.total_ns > single.total_ns       # but not a free 8x


@pytest.mark.parametrize("banks", [2, 4, 8, 16])
def test_multibank_throughput_beats_sequential(P, banks):
    unit = P.CostModel().maj_unit_programs(3, 8)
    progs = [P.ctrl.retarget_program(p, i % banks)
             for i in range(2 * banks) for p in unit]
    flat = [c for p in progs for c in p]
    seq_ns = P.cmds.CommandScheduler(P.T).schedule(flat).total_ns
    ctrl_ns = P.ctrl.MemoryController(n_banks=banks).schedule(progs).total_ns
    assert ctrl_ns < seq_ns


def test_refresher_preempts_apa_stream_atomically(P):
    ctrl = P.ctrl.MemoryController(n_banks=1, trefi=300.0, trfc=100.0)
    stream = [P.cmds.prog_apa_charge_share(0, 0, 1, P.T) for _ in range(10)]
    tr = ctrl.schedule(stream)
    assert tr.n_refreshes > 0
    assert tr.refresh_stall_ns > 0
    for start, end in tr.refresh_windows:
        for _, t in tr.events:
            assert not (start + 1e-9 < t < end - 1e-9)
    per_prog = [tr.issue_times[i:i + 5]
                for i in range(0, len(tr.issue_times), 5)]
    for times in per_prog:
        for start, end in tr.refresh_windows:
            assert all(t <= start + 1e-9 for t in times) or \
                all(t >= end - 1e-9 for t in times)
    no_ref = ctrl.schedule(stream, refresh=False)
    assert tr.total_ns > no_ref.total_ns


def test_refresh_stall_scales_with_trefi(P):
    unit = P.CostModel().maj_unit_programs(3, 8)
    slow = P.ctrl.MemoryController(n_banks=16).batch_cost(unit, 16)
    fast = P.ctrl.MemoryController(n_banks=16,
                                   trefi=3900.0).batch_cost(unit, 16)
    assert 1.0 < slow.refresh_factor < fast.refresh_factor


def test_refresh_reopens_row_for_pending_access(P):
    Cmd, Op, T = P.cmds.Cmd, P.cmds.Op, P.T
    ctrl = P.ctrl.MemoryController(n_banks=1, trefi=120.0, trfc=60.0)
    progs = [[Cmd(Op.ACT, 0, 7, 0.0, "a"), Cmd(Op.RD, 0, 7, T.trcd, "r")]]
    progs += [[Cmd(Op.RD, 0, 7, T.tccd_l, f"hit{i}")] for i in range(40)]
    tr = ctrl.schedule(progs)
    assert tr.n_refreshes >= 1
    for _, end in tr.refresh_windows:
        after = [c for c, t in tr.events if t >= end - 1e-9]
        if after:
            assert after[0].op is Op.ACT and after[0].tag == "bm.reopen"


def test_batch_cost_speedup_bounded_and_cached(P):
    ctrl = P.ctrl.MemoryController(n_banks=16)
    unit = P.CostModel().maj_unit_programs(3, 8)
    bc = ctrl.batch_cost(unit, 16)
    assert 1.0 < bc.parallel_speedup <= 16.0
    assert bc.refresh_factor >= 1.0
    assert ctrl.batch_cost(unit, 16) is bc  # cached


def test_engine_controller_pricing_adds_refresh_term(P):
    legacy = P.Engine(mfr="M", width=32, banks=16)
    ctrl = P.Engine(mfr="M", width=32, banks=16, controller="auto")
    a = np.arange(65536 * 4, dtype=np.uint64)
    legacy._add(a, a)
    ctrl._add(a, a)
    assert legacy.stats.refresh_stall_ns == 0.0
    assert ctrl.stats.refresh_stall_ns > 0.0
    assert ctrl.stats.latency_ns >= legacy.stats.latency_ns
    np.testing.assert_array_equal(legacy._add(a, a), ctrl._add(a, a))


# --------------------------------------------------------------------- #
# tests/controller/test_crossbar.py, through both packages
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("lookahead", [1, 2, 8, 64])
def test_single_port_matches_legacy_schedule(P, lookahead):
    progs = unit_programs(P)
    mc = P.ctrl.MemoryController()
    legacy = mc.schedule(progs)
    xbar = mc.schedule_concurrent([progs], lookahead=lookahead)
    assert xbar.cmds == legacy.cmds
    assert xbar.issue_times == legacy.issue_times
    assert xbar.total_ns == legacy.total_ns
    assert xbar.energy_j == legacy.energy_j
    assert xbar.n_refreshes == legacy.n_refreshes
    assert xbar.n_ports == 1


def test_single_port_counters_match_legacy(P):
    progs = unit_programs(P)
    mc = P.ctrl.MemoryController()
    legacy = mc.schedule(progs).counters().as_dict()["counters"]
    xbar = mc.schedule_concurrent([progs]).counters().as_dict()["counters"]
    for k, v in legacy.items():
        assert xbar[k] == v, k


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("n_ports", [2, 5, 8])
def test_no_timing_violations_under_interleaving(P, seed, n_ports):
    rng = np.random.default_rng(seed)
    xb = P.ctrl.Crossbar(n_ports=n_ports, lookahead=int(rng.integers(1, 9)),
                         auto_precharge=bool(rng.random() < 0.5))
    submit_all(xb, seeded_requests(P, rng, n_ports))
    tr = xb.run()
    assert P.tel.check_timing_invariants(tr) == []
    assert all(len(xb.port(p)) == 0 for p in range(n_ports))


def test_work_conserved_per_port(P):
    rng = np.random.default_rng(7)
    n_ports = 4
    streams = seeded_requests(P, rng, n_ports)
    xb = P.ctrl.Crossbar(n_ports=n_ports, refresh=False)
    submit_all(xb, streams)
    tr = xb.run()
    c = P.tel.derive_port_counters(tr)
    assert [c[f"port{p}.seqs"] for p in range(n_ports)] \
        == [len(reqs) for reqs in streams]
    assert sum(c[f"port{p}.cmds"] for p in range(n_ports)) \
        == sum(1 for cmd in tr.cmds if cmd.op is not P.cmds.Op.NOP)
    assert len(tr.port_of) == len(tr.cmds)


def test_round_robin_fairness_on_contended_bank(P):
    n_ports, n_req = 4, 25
    xb = P.ctrl.Crossbar(n_ports=n_ports, refresh=False)
    for p in range(n_ports):
        for i in range(n_req):
            xb.port(p).submit_access(0, row=i % 3)
    c = P.tel.derive_port_counters(xb.run())
    assert [c[f"port{p}.seqs"] for p in range(n_ports)] == [n_req] * n_ports


def test_no_port_starved_beyond_window(P):
    T = P.T
    n_ports = 8
    xb = P.ctrl.Crossbar(n_ports=n_ports, refresh=True)
    for p in range(n_ports):
        for i in range(20):
            xb.port(p).submit_access(0, row=(p + i) % 5)
    c = P.tel.derive_port_counters(xb.run())
    seq_span = T.trp + T.trcd + T.tras + T.tbl + T.twr
    bound = n_ports * seq_span + T.trfc + 3 * T.tck
    for p in range(n_ports):
        assert c[f"port{p}.grant_gap_max_ns"] <= bound


def test_late_port_granted_within_lookahead(P):
    lookahead = 4
    xb = P.ctrl.Crossbar(n_ports=2, lookahead=lookahead, refresh=False)
    for i in range(50):
        xb.port(0).submit_access(0, row=i % 2)
    xb.port(1).submit_access(0, row=7)
    tr = xb.run()
    first_seqs = []
    for sq, p in zip(tr.seqs, tr.port_of):
        if sq not in first_seqs:
            first_seqs.append(sq)
            if p == 1:
                break
    assert len(first_seqs) <= lookahead + 1


def test_per_port_bank_fifo_order(P):
    rng = np.random.default_rng(3)
    n_ports = 3
    xb = P.ctrl.Crossbar(n_ports=n_ports, refresh=False)
    submit_all(xb, seeded_requests(P, rng, n_ports, n_banks=4))
    tr = xb.run()
    seen: dict = {}
    for sq, p in zip(tr.seqs, tr.port_of):
        bank, sid = sq
        prev = seen.get((p, bank))
        if prev is None or sid != prev:
            assert prev is None or sid > prev, (p, bank, prev, sid)
            seen[(p, bank)] = sid


def test_refresh_drains_inflight_sequences(P):
    xb = P.ctrl.Crossbar(n_ports=4, trefi=300.0, trfc=80.0)
    for p in range(4):
        for i in range(40):
            xb.port(p).submit_access((p + i) % 16, row=i % 3)
    tr = xb.run()
    assert tr.n_refreshes > 0
    assert P.tel.check_timing_invariants(tr) == []


def corrupted(P):
    """The negative control's trace and its hand-corrupted copy (the
    second ACT moved 0.01 ns after the first)."""
    xb = P.ctrl.Crossbar(n_ports=2, refresh=False)
    for p in range(2):
        for i in range(10):
            xb.port(p).submit_access(i % 8, row=0)
    tr = xb.run()
    bad = copy.copy(tr)
    bad.issue_times = list(tr.issue_times)
    acts = [i for i, c in enumerate(tr.cmds) if c.op is P.cmds.Op.ACT]
    bad.issue_times[acts[1]] = bad.issue_times[acts[0]] + 0.01
    return tr, bad


def test_invariant_checker_detects_corruption(P):
    tr, bad = corrupted(P)
    assert P.tel.check_timing_invariants(tr) == []
    assert P.tel.check_timing_invariants(bad)


def test_auto_precharge_attaches_pre_to_owning_sequence(P):
    Op = P.cmds.Op

    def trace(ap):
        xb = P.ctrl.Crossbar(n_ports=1, auto_precharge=ap, refresh=False)
        for i in range(10):
            xb.port(0).submit_access(0, row=i % 2)   # always a row switch
        return xb.run()

    tr = trace(True)
    assert P.tel.check_timing_invariants(tr) == []
    by_seq: dict = {}
    for cmd, sq in zip(tr.cmds, tr.seqs):
        by_seq.setdefault(sq, []).append(cmd.op)
    closing = [ops for ops in by_seq.values() if ops[-1] is Op.PRE]
    assert len(closing) >= len(by_seq) - 1
    tr_off = trace(False)
    n = sum(1 for c in tr.cmds if c.op is not Op.NOP)
    n_off = sum(1 for c in tr_off.cmds if c.op is not Op.NOP)
    assert abs(n - n_off) <= 1


def test_port_and_config_validation(P):
    Cmd, Op = P.cmds.Cmd, P.cmds.Op
    with pytest.raises(ValueError):
        P.ctrl.Crossbar(n_ports=0)
    with pytest.raises(ValueError):
        P.ctrl.Crossbar(lookahead=0)
    xb = P.ctrl.Crossbar(n_ports=2, n_banks=4)
    with pytest.raises(ValueError):
        xb.port(0).submit_access(4, row=0)
    with pytest.raises(ValueError):
        xb.port(0).submit([[Cmd(Op.ACT, 0, 1, 0.0), Cmd(Op.ACT, 1, 1, 0.0)]])


# --------------------------------------------------------------------- #
# The port held to the reference exactly
# --------------------------------------------------------------------- #


def _golden():
    return json.loads(FIXTURE.read_text())["schedule"]


def test_port_reproduces_golden_schedule():
    fix = _golden()
    P = _NS["repro_torch"]
    tr = P.ctrl.MemoryController().schedule(unit_programs(P))
    assert len(tr.cmds) == fix["n_events"]
    assert tr.total_ns == fix["total_ns"]
    assert tr.energy_j == fix["energy_j"]
    assert tr.n_refreshes == fix["n_refreshes"]
    assert digest(tr) == fix["events_sha256"]


@pytest.mark.parametrize("lookahead", [1, 4, 8])
def test_port_crossbar_single_port_reproduces_golden(lookahead):
    fix = _golden()
    P = _NS["repro_torch"]
    tr = P.ctrl.MemoryController().schedule_concurrent(
        [unit_programs(P)], lookahead=lookahead)
    assert digest(tr) == fix["events_sha256"]
    assert tr.total_ns == fix["total_ns"]
    assert tr.energy_j == fix["energy_j"]
    assert tr.n_refreshes == fix["n_refreshes"]


def random_stream(P, rng, n_progs=40, n_banks=8):
    """A seeded stream of single-bank programs of every kind."""
    kinds = sorted(all_programs(P))
    progs = all_programs(P)
    return [progs[kinds[int(rng.integers(len(kinds)))]](
        int(rng.integers(n_banks))) for _ in range(n_progs)]


def trace_fields(tr) -> dict:
    out = {"digest": digest(tr), "total_ns": tr.total_ns,
           "energy_j": tr.energy_j, "n_acts": tr.n_acts,
           "n_pres": tr.n_pres, "n_rdwr": tr.n_rdwr,
           "n_refreshes": tr.n_refreshes,
           "refresh_stall_ns": tr.refresh_stall_ns,
           "refresh_windows": list(tr.refresh_windows),
           "per_bank_ns": dict(tr.per_bank_ns)}
    for k in ("port_of", "seqs", "n_ports"):
        if hasattr(tr, k):
            out[k] = getattr(tr, k)
    return out


def both(fn):
    """``fn(P, rng)`` for each package from the same seed."""
    return [fn(_NS[name]) for name in PKGS]


@pytest.mark.parametrize("seed", range(4))
def test_seeded_streams_schedule_identically(seed):
    def run(P):
        rng = np.random.default_rng(seed)
        mc = P.ctrl.MemoryController(n_banks=8, trefi=2000.0 + 500 * seed)
        stream = random_stream(P, rng)
        unit = P.CostModel().maj_unit_programs(*[(3, 4), (3, 8), (5, 8),
                                                 (5, 16)][seed])
        order = tuple(int(b) for b in rng.permutation(8))
        streams = [random_stream(P, rng, 15) for _ in range(3)]
        return {
            "schedule": trace_fields(mc.schedule(stream)),
            "schedule_norefresh": trace_fields(mc.schedule(stream,
                                                           refresh=False)),
            "batch": trace_fields(mc.schedule_batch(unit, 4, n_batches=3)),
            "batch_order": trace_fields(mc.schedule_batch(
                unit, 4, bank_order=order)),
            "concurrent": trace_fields(mc.schedule_concurrent(
                streams, lookahead=1 + seed, auto_precharge=bool(seed % 2))),
            "batch_cost": mc.batch_cost(unit, 8).__dict__,
            "batch_cost_order": mc.batch_cost(unit, 8,
                                              bank_order=order).__dict__,
        }

    ref, port = both(run)
    assert port == ref


@pytest.mark.parametrize("seed", range(3))
def test_derived_counters_and_verdicts_match_reference(seed):
    def run(P):
        rng = np.random.default_rng(seed)
        n_ports = 2 + seed
        xb = P.ctrl.Crossbar(n_ports=n_ports, lookahead=1 + 3 * seed,
                             auto_precharge=bool(seed % 2),
                             trefi=600.0 + 300 * seed)
        submit_all(xb, seeded_requests(P, rng, n_ports))
        tr = xb.run()
        mc = P.ctrl.MemoryController(n_banks=16)
        single = mc.schedule(unit_programs(P, 16))
        good, bad = corrupted(P)
        return {
            "controller": P.tel.derive_controller_counters(tr).as_dict(),
            "port": P.tel.derive_port_counters(tr).as_dict(),
            "trace_counters": tr.counters().as_dict(),
            "single": single.counters().as_dict(),
            "legacy": P.cmds.CommandScheduler(P.T).schedule(
                all_programs(P)["bulk_write"](0)).counters().as_dict(),
            "verdict": P.tel.check_timing_invariants(tr),
            "verdict_good": P.tel.check_timing_invariants(good),
            "verdict_bad": P.tel.check_timing_invariants(bad),
        }

    ref, port = both(run)
    assert ref["verdict_bad"]           # the corruption is caught
    assert port == ref
