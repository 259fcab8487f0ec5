"""Bank-parallelism sweep (§7): N MAJ ops spread over B banks, scheduled by
the MemoryController (bank machines + multiplexer + refresher) vs the same
command stream through the sequential CommandScheduler.

The speedup from overlapped issue is *measured from the scheduled trace*,
not assumed: tFAW/tRRD cap the activation rate, so effective parallelism
saturates well below the bank count (the honest version of the paper's
16-bank scaling), and REF injection shows up as a small extra stall.

The ``bankpar.refpost_p*`` rows sweep the refresher's REF postponing
policy (JEDEC allows batching up to 8 REFs into one rank lockout)
through ``MemoryController.batch_cost`` — the same cost-plane entry
point the engine prices through (``EngineConfig.ref_postponing``):
postponing trades lockout frequency for lockout length, so the
steady-state refresh factor shifts while the raw makespan is untouched.

The PyTorch port's counterpart of ``benchmarks/bank_parallelism.py``:
the same rows and ``derived`` strings from the port's memory controller,
a host simulation; ``run`` takes ``device`` only so that every figure
module is called alike.
"""

from __future__ import annotations

from benchmarks.common import Row, record_counters, row, timed_us
from repro_torch.controller import MemoryController, retarget_program
from repro_torch.core import commands as cmds
from repro_torch.core.cost_model import CostModel
from repro_torch.core.timing import DDR4_2400

N_OPS = 32
ROW_BITS = 65536


def run(device="cuda") -> list[Row]:
    t = DDR4_2400
    cm = CostModel(row_bits=ROW_BITS)
    unit = cm.maj_unit_programs(3, 8)   # one MAJ3@8 op (the Fig 17 staple)

    # Sequential baseline: the identical command stream through the legacy
    # scheduler (which serializes rank-wide regardless of bank tags).
    flat = [c for _ in range(N_OPS) for prog in unit for c in prog]
    seq_ns = cmds.CommandScheduler(t).schedule(flat).total_ns
    seq_thr = N_OPS * ROW_BITS / (seq_ns * 1e-9)

    rows: list[Row] = []
    rows.append(row("bankpar.sequential", seq_ns / 1e3,
                    f"total={seq_ns:.0f}ns maj_thr={seq_thr:.3e}elem/s "
                    f"(legacy CommandScheduler, {N_OPS} MAJ3@8 ops)"))

    for banks in (1, 2, 4, 8, 16):
        ctrl = MemoryController(n_banks=banks)
        programs = [retarget_program(prog, i % banks)
                    for i in range(N_OPS) for prog in unit]
        us, tr = timed_us(ctrl.schedule, programs, repeat=1)
        thr = N_OPS * ROW_BITS / (tr.total_ns * 1e-9)
        rows.append(row(
            f"bankpar.ctrl_b{banks}", us,
            f"total={tr.total_ns:.0f}ns maj_thr={thr:.3e}elem/s "
            f"speedup_vs_seq={seq_ns / tr.total_ns:.2f}x "
            f"refreshes={tr.n_refreshes} "
            f"refresh_stall={tr.refresh_stall_ns:.0f}ns"))
        # Post-hoc derived controller counters ride along in the BENCH
        # baseline (bus utilization, row hits, tRRD/tFAW stalls).
        record_counters(f"bankpar.ctrl_b{banks}", tr.counters())

    # 8 concurrent client streams through the crossbar: each port owns a
    # slice of the 16 banks, the multiplexer still enforces rank-wide
    # tFAW/tRRD — overlap is makespan vs the sum of per-stream serial
    # schedules, and the replayed audit trail must be violation-free.
    from repro_torch.telemetry import check_timing_invariants
    n_ports = 8
    ctrl = MemoryController(n_banks=16)
    streams = [[retarget_program(prog, (i * n_ports + p) % 16)
                for i in range(N_OPS // n_ports) for prog in unit]
               for p in range(n_ports)]
    us, tr = timed_us(ctrl.schedule_concurrent, streams, repeat=1)
    serial_ns = sum(ctrl.schedule(s).total_ns for s in streams)
    viol = len(check_timing_invariants(tr))
    rows.append(row(
        "engine.crossbar_8client", us,
        f"makespan={tr.total_ns:.0f}ns serial_sum={serial_ns:.0f}ns "
        f"overlap={serial_ns / tr.total_ns:.2f}x "
        f"violations={viol} refreshes={tr.n_refreshes} "
        f"({n_ports} client ports, per-bank round-robin grants)"))
    record_counters("engine.crossbar_8client", tr.counters())

    # REF postponing sweep: batch_cost prices the same 16-bank MAJ unit
    # under each policy — refresh_factor is the steady-state slowdown the
    # engine multiplies into every op's latency.
    for post in (1, 2, 4, 8):
        ctrl = MemoryController(n_banks=16, postponing=post)
        us, bc = timed_us(ctrl.batch_cost, unit, 16, repeat=1)
        rows.append(row(
            f"bankpar.refpost_p{post}", us,
            f"refresh_factor={bc.refresh_factor:.4f} "
            f"amortized={bc.amortized_ns:.0f}ns "
            f"makespan={bc.makespan_ns:.0f}ns "
            f"refreshes={bc.n_refreshes} "
            f"lockout={ctrl.t.trp + ctrl.trfc * post:.0f}ns "
            f"(postponing={post} REFs per rank lockout)"))
    return rows
