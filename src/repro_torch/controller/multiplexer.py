"""Shared command-bus arbiter (LiteDRAM/gram ``Multiplexer`` analogue).

Event-driven in continuous ns time: at each step the multiplexer computes,
for every bank machine's head command, the earliest legal issue time under

  * the bank's own ``min_gap`` sequencing (BankMachine),
  * tRRD between ACTs rank-wide (same constraint the sequential
    ``CommandScheduler`` applies, so single-bank schedules match exactly),
  * tFAW — at most 4 ACTs per rolling window,
  * tCCD_S between column (RD/WR) commands on the shared data bus,
  * command-bus occupancy — one (non-NOP) command per tCK,

then issues the earliest candidate, breaking ties round-robin.  When the
refresher is due, banks finish their in-flight sequence but may not start a
new one; once all pending heads sit at sequence boundaries the refresher
gets the rank for tRP + tRFC and every bank's open row is closed.
"""

from __future__ import annotations

import dataclasses
from collections import deque

from repro_torch.controller.bank_machine import BankMachine
from repro_torch.controller.refresher import Refresher
from repro_torch.core.commands import Cmd, Op
from repro_torch.core.timing import DramTimings

_EPS = 1e-9


@dataclasses.dataclass
class MuxResult:
    events: list[tuple[Cmd, float]]
    n_acts: int
    n_pres: int
    n_rdwr: int
    energy_j: float
    refresh_windows: list[tuple[float, float]]
    n_refreshes: int
    refresh_stall_ns: float
    per_bank_last: dict[int, float]
    # Timing set the arbitration ran under (for ``.counters()`` derivation).
    timings: DramTimings | None = None
    # Parallel to ``events``: (bank, seq_id) of the sequence each command
    # belongs to, so a crossbar can attribute issued commands back to the
    # client port that submitted the sequence (pure audit metadata — the
    # arbitration itself never reads it).
    seqs: list[tuple[int, int]] | None = None

    @property
    def total_ns(self) -> float:
        return self.events[-1][1] if self.events else 0.0

    def counters(self, timings: DramTimings | None = None):
        """Derive a :class:`repro_torch.telemetry.CounterBank` from this trace
        (commands per type, bus utilization, row hit/miss/conflict,
        tRRD/tFAW stall time, refresh lockout). Pure post-hoc replay of
        ``events`` — the arbitration itself stays byte-identical."""
        from repro_torch.telemetry import derive_controller_counters
        return derive_controller_counters(self, timings)


class CommandMultiplexer:
    def __init__(self, timings: DramTimings, machines: list[BankMachine],
                 refresher: Refresher | None = None, feeder=None):
        self.t = timings
        self.machines = machines
        self.refresher = refresher
        # Optional refill hook called at the top of every arbitration step
        # (before the bank-machine scan).  A crossbar uses it to top the
        # per-bank queues up to its lookahead depth from the client ports;
        # with ``feeder=None`` the loop below is byte-identical to the
        # pre-crossbar multiplexer.
        self.feeder = feeder

    # ------------------------------------------------------------------ #

    def _rank_constraints(self, when: float, cmd: Cmd, last_act: float,
                          faw: deque, last_col: float,
                          last_bus: float) -> float:
        t = self.t
        if cmd.op is Op.ACT:
            when = max(when, last_act + t.trrd_s)
            # Rolling four-activation window — same rule as the sequential
            # CommandScheduler (the deque never exceeds 4 entries).
            if len(faw) >= 4 and when - faw[0] < t.tfaw:
                when = faw[0] + t.tfaw
        elif cmd.op in (Op.RD, Op.WR):
            when = max(when, last_col + t.tccd_s)
        if cmd.op is not Op.NOP:
            when = max(when, last_bus + t.tck)
        return when

    def run(self) -> MuxResult:
        t = self.t
        ref = self.refresher
        events: list[tuple[Cmd, float]] = []
        n_acts = n_pres = n_rdwr = 0
        energy = 0.0
        last_act = -1e30
        last_col = -1e30
        last_bus = -1e30
        faw: deque[float] = deque()
        rr = 0
        nb = len(self.machines)
        refresh_stall = 0.0
        seqs: list[tuple[int, int]] = []

        while True:
            if self.feeder is not None:
                self.feeder()
            if not any(len(bm) for bm in self.machines):
                break
            best_idx = -1
            best_time = float("inf")
            blocked = False
            for off in range(nb):
                idx = (rr + off) % nb
                bm = self.machines[idx]
                q = bm.head()
                if q is None:
                    continue
                when = self._rank_constraints(bm.earliest_issue(), q.cmd,
                                              last_act, faw, last_col,
                                              last_bus)
                if ref is not None and q.seq_start and ref.blocks(when):
                    blocked = True
                    continue
                if when < best_time - _EPS:
                    best_time, best_idx = when, idx
            if best_idx < 0:
                # Every pending bank sits at a sequence boundary past the
                # refresh deadline: grant the rank to the refresher.
                assert blocked and ref is not None
                idle = max((bm.last_issue or 0.0) for bm in self.machines)
                start = max(ref.next_due, idle, last_bus + t.tck)
                end = ref.execute(start)
                for bm in self.machines:
                    bm.note_refresh(end)
                last_bus = start
                energy += t.e_ref * ref.postponing
                refresh_stall += end - start
                continue

            bm = self.machines[best_idx]
            q = bm.issue(best_time)
            cmd = q.cmd
            events.append((cmd, best_time))
            seqs.append((bm.bank, q.seq_id))
            if cmd.op is Op.ACT:
                if len(faw) >= 4:
                    faw.popleft()
                faw.append(best_time)
                last_act = best_time
                n_acts += 1
                energy += t.e_act
            elif cmd.op is Op.PRE:
                n_pres += 1
                energy += t.e_pre
            elif cmd.op in (Op.RD, Op.WR):
                last_col = best_time
                n_rdwr += 1
                energy += t.e_rdwr_burst
            if cmd.op is not Op.NOP:
                last_bus = best_time
            rr = (best_idx + 1) % nb

        per_bank = {bm.bank: bm.last_issue for bm in self.machines
                    if bm.last_issue is not None}
        return MuxResult(events=events, n_acts=n_acts, n_pres=n_pres,
                         n_rdwr=n_rdwr, energy_j=energy,
                         refresh_windows=list(ref.windows) if ref else [],
                         n_refreshes=ref.n_refreshes if ref else 0,
                         refresh_stall_ns=refresh_stall,
                         per_bank_last=per_bank, timings=t, seqs=seqs)
