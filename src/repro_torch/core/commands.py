"""DRAM command DSL + scheduler.

PuM primitives are expressed as *command programs*; the scheduler assigns
issue times honoring the constraints that still bind under PuM operation:
tFAW (four-activation window, Appendix A power budget), tRRD between ACTs to
different banks, and explicit intra-sequence gaps (violated or nominal) that
the program encodes as ``min_gap`` from the previous command on the same bank.

This gives every benchmark an auditable latency/energy accounting, and the
logical chip model executes the same programs for bit-exact results — one
source of truth for both correctness and cost.
"""

from __future__ import annotations

import dataclasses
import enum
from collections import deque
from typing import Iterable

from repro_torch.core.timing import DramTimings


class Op(enum.Enum):
    ACT = "act"
    PRE = "pre"
    WR = "wr"
    RD = "rd"
    NOP = "nop"


@dataclasses.dataclass(frozen=True)
class Cmd:
    op: Op
    bank: int = 0
    row: int = -1
    # Minimum time since the previous command issued to the same bank.
    # This encodes both nominal (tRAS, tRP, tRCD) and violated (t_apa_gap)
    # sequencing: programs are explicit about their timing intent.
    min_gap: float = 0.0
    tag: str = ""


@dataclasses.dataclass
class ScheduleResult:
    total_ns: float
    energy_j: float
    n_acts: int
    n_pres: int
    n_rdwr: int
    issue_times: list[float]
    # Parallel to ``issue_times``: the command issued at each time, so traces
    # are auditable per command (scheduled multi-bank streams reorder across
    # programs, so positional indexing into the input program is not enough).
    cmds: list[Cmd] = dataclasses.field(default_factory=list)

    @property
    def events(self) -> list[tuple[Cmd, float]]:
        """(cmd, issue_time) pairs in issue order."""
        return list(zip(self.cmds, self.issue_times))

    def counters(self, timings: DramTimings | None = None):
        """Derive a :class:`repro_torch.telemetry.CounterBank` from this
        trace (bus utilization, row hit/miss/conflict, tRRD/tFAW stalls).
        Pure post-hoc replay — the schedule itself is untouched."""
        from repro_torch.telemetry import derive_controller_counters
        return derive_controller_counters(self, timings)


class CommandScheduler:
    """Assigns issue times to a command stream.

    Constraints enforced:
      * per-bank ``min_gap`` sequencing (the program's timing intent),
      * tFAW: at most 4 ACTs per rolling tFAW window (rank-wide),
      * tRRD_S between ACTs to different banks.
    """

    def __init__(self, timings: DramTimings):
        self.t = timings

    def schedule(self, program: Iterable[Cmd]) -> ScheduleResult:
        t = self.t
        now = 0.0
        last_per_bank: dict[int, float] = {}
        act_window: deque[float] = deque()
        last_act = -1e30
        issue_times: list[float] = []
        issued: list[Cmd] = []
        n_acts = n_pres = n_rdwr = 0
        energy = 0.0
        for cmd in program:
            earliest = now
            prev = last_per_bank.get(cmd.bank)
            if prev is not None:
                earliest = max(earliest, prev + cmd.min_gap)
            else:
                earliest = max(earliest, now + cmd.min_gap if not last_per_bank else now)
            if cmd.op is Op.ACT:
                earliest = max(earliest, last_act + t.trrd_s)
                while len(act_window) >= 4:
                    # 4 most recent ACT issue times; 5th must wait tFAW.
                    window_start = act_window[0]
                    if earliest - window_start >= t.tfaw:
                        act_window.popleft()
                    else:
                        earliest = window_start + t.tfaw
                        act_window.popleft()
            issue_times.append(earliest)
            issued.append(cmd)
            last_per_bank[cmd.bank] = earliest
            now = earliest
            if cmd.op is Op.ACT:
                act_window.append(earliest)
                last_act = earliest
                n_acts += 1
                energy += t.e_act
            elif cmd.op is Op.PRE:
                n_pres += 1
                energy += t.e_pre
            elif cmd.op in (Op.WR, Op.RD):
                n_rdwr += 1
                energy += t.e_rdwr_burst
        # The stream's latency includes the tail gap implied by the final
        # command's own duration; programs end with a PRE whose min_gap
        # already accounts for restore, so add one tRP tail.
        total = (issue_times[-1] if issue_times else 0.0)
        return ScheduleResult(total_ns=total, energy_j=energy, n_acts=n_acts,
                              n_pres=n_pres, n_rdwr=n_rdwr,
                              issue_times=issue_times, cmds=issued)


# ---------------------------------------------------------------------- #
# Program builders for the PuM primitives (shared by cost model + chip).
# ---------------------------------------------------------------------- #

def prog_apa_charge_share(bank: int, rf: int, rs: int,
                          t: DramTimings) -> list[Cmd]:
    """Many-input charge sharing (§5.2.2): ACT-(gap)-PRE-(gap)-ACT, then the
    sense amp resolves + restores all activated rows, and the bank precharges."""
    return [
        Cmd(Op.ACT, bank, rf, 0.0, "apa.act1"),
        Cmd(Op.PRE, bank, -1, t.t_apa_gap, "apa.pre"),
        Cmd(Op.ACT, bank, rs, t.t_apa_gap, "apa.act2"),
        Cmd(Op.PRE, bank, -1, t.tras, "apa.pre2"),
        Cmd(Op.NOP, bank, -1, t.trp, "apa.done"),
    ]


def prog_aap_multi_row_init(bank: int, rf: int, rs: int,
                            t: DramTimings) -> list[Cmd]:
    """Multi-RowInit (§5.2.1): first ACT honors tRAS (full sense of R_F),
    PRE violated by second ACT; sense amps overdrive all activated rows."""
    return [
        Cmd(Op.ACT, bank, rf, 0.0, "aap.act1"),
        Cmd(Op.PRE, bank, -1, t.tras, "aap.pre"),
        Cmd(Op.ACT, bank, rs, t.t_apa_gap, "aap.act2"),
        Cmd(Op.PRE, bank, -1, t.tras, "aap.pre2"),
        Cmd(Op.NOP, bank, -1, t.trp, "aap.done"),
    ]


def prog_bulk_write(bank: int, rf: int, rs: int, n_bursts: int,
                    t: DramTimings) -> list[Cmd]:
    """Bulk-Write (§5.2.3): charge-share APA, then WR bursts drive all
    activated rows; one WR command stream writes 2^n rows at once."""
    prog = [
        Cmd(Op.ACT, bank, rf, 0.0, "bw.act1"),
        Cmd(Op.PRE, bank, -1, t.t_apa_gap, "bw.pre"),
        Cmd(Op.ACT, bank, rs, t.t_apa_gap, "bw.act2"),
        Cmd(Op.WR, bank, rs, t.trcd, "bw.wr0"),
    ]
    for i in range(1, n_bursts):
        prog.append(Cmd(Op.WR, bank, rs, t.tccd_l, f"bw.wr{i}"))
    prog.append(Cmd(Op.PRE, bank, -1, t.twr, "bw.pre2"))
    prog.append(Cmd(Op.NOP, bank, -1, t.trp, "bw.done"))
    return prog


def prog_write_row(bank: int, row: int, n_bursts: int,
                   t: DramTimings) -> list[Cmd]:
    """Nominal full-row write (host -> DRAM): ACT, WR bursts, PRE."""
    prog = [
        Cmd(Op.ACT, bank, row, 0.0, "wr.act"),
        Cmd(Op.WR, bank, row, t.trcd, "wr.wr0"),
    ]
    for i in range(1, n_bursts):
        prog.append(Cmd(Op.WR, bank, row, t.tccd_l, f"wr.wr{i}"))
    prog.append(Cmd(Op.PRE, bank, -1, t.twr, "wr.pre"))
    prog.append(Cmd(Op.NOP, bank, -1, t.trp, "wr.done"))
    return prog


def prog_read_row(bank: int, row: int, n_bursts: int,
                  t: DramTimings) -> list[Cmd]:
    prog = [
        Cmd(Op.ACT, bank, row, 0.0, "rd.act"),
        Cmd(Op.RD, bank, row, t.trcd, "rd.rd0"),
    ]
    for i in range(1, n_bursts):
        prog.append(Cmd(Op.RD, bank, row, t.tccd_l, f"rd.rd{i}"))
    prog.append(Cmd(Op.PRE, bank, -1, t.trtp + t.tbl, "rd.pre"))
    prog.append(Cmd(Op.NOP, bank, -1, t.trp, "rd.done"))
    return prog


def prog_frac(bank: int, row: int, t: DramTimings) -> list[Cmd]:
    """FracDRAM Frac op: truncated-restore ACT then PRE -> row at ~VDD/2."""
    return [
        Cmd(Op.ACT, bank, row, 0.0, "frac.act"),
        Cmd(Op.PRE, bank, -1, t.t_frac, "frac.pre"),
        Cmd(Op.NOP, bank, -1, t.trp, "frac.done"),
    ]
