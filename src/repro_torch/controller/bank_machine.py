"""Per-bank command state machine (LiteDRAM/gram ``BankMachine`` analogue).

Each bank machine owns a FIFO of commands grouped into *sequences* (one PuM
command program each).  A sequence is the atomicity unit for refresh: the
multiplexer may interleave commands of different banks freely, but a REF can
only take the rank once every in-flight sequence has drained — a violated
timing ACT-PRE-ACT (APA/AAP) can never be split by a refresh.

The bank machine tracks open-row state across issued commands and, for
nominal row accesses submitted via :meth:`enqueue_access`, applies the
row-hit/row-miss precharge policy (open-page by default, closed-page /
auto-precharge optionally): a hit issues the column command directly, an
idle bank activates first, a miss precharges, re-activates, then issues.
"""

from __future__ import annotations

import dataclasses
import enum
from collections import deque

from repro_torch.core.commands import Cmd, Op
from repro_torch.core.timing import DramTimings


class BankState(enum.Enum):
    IDLE = "idle"        # all rows precharged
    ACTIVE = "active"    # one row latched in the sense amps


@dataclasses.dataclass
class QueuedCmd:
    cmd: Cmd
    seq_start: bool      # first command of a sequence (refresh-safe point)
    seq_id: int


class BankMachine:
    """FSM + command queue for one DRAM bank.

    The multiplexer asks :meth:`earliest_issue` when this bank's head command
    could go out under *per-bank* constraints (the program's ``min_gap``
    sequencing and any post-refresh floor); rank-wide constraints (tFAW,
    tRRD, tCCD, bus occupancy) are the multiplexer's job — mirroring the
    split in LiteDRAM/gram.
    """

    def __init__(self, bank_id: int, timings: DramTimings,
                 open_page: bool = True):
        self.bank = bank_id
        self.t = timings
        self.open_page = open_page
        self.queue: deque[QueuedCmd] = deque()
        self.state = BankState.IDLE
        self.open_row: int | None = None
        self.last_issue: float | None = None  # time of last issued command
        self.floor = 0.0                      # earliest issue (refresh lockout)
        self._seq_counter = 0
        # Projected state at the queue tail, used by the precharge policy.
        self._tail_row: int | None = None
        self._tail_col_op: Op | None = None

    # ------------------------------------------------------------------ #
    # Enqueue
    # ------------------------------------------------------------------ #

    def enqueue_program(self, prog) -> int:
        """Queue one PuM command program as an atomic sequence."""
        sid = self._seq_counter
        self._seq_counter += 1
        for i, cmd in enumerate(prog):
            if cmd.bank != self.bank:
                cmd = dataclasses.replace(cmd, bank=self.bank)
            self.queue.append(QueuedCmd(cmd, i == 0, sid))
            if cmd.op is Op.ACT:
                self._tail_row = cmd.row
            elif cmd.op is Op.PRE:
                self._tail_row = None
            elif cmd.op in (Op.RD, Op.WR):
                self._tail_col_op = cmd.op
        return sid

    def enqueue_access(self, row: int, write: bool = False,
                       n_bursts: int = 1,
                       auto_precharge: bool | None = None) -> int:
        """Nominal row access under the precharge policy (row hit/miss).

        ``auto_precharge`` overrides the machine-level page policy for this
        one access: ``True`` appends a closing PRE (closed-page), ``False``
        leaves the row open, ``None`` (default) follows ``self.open_page``.
        The crossbar uses this for lookahead-driven auto-precharge — when
        the next queued request for the bank targets a different row, the
        PRE rides along with this access instead of costing a conflict."""
        t = self.t
        col = Op.WR if write else Op.RD
        prog: list[Cmd] = []
        if self._tail_row == row:                       # row hit
            first_gap = t.tccd_l
        elif self._tail_row is None:                    # bank idle
            prog.append(Cmd(Op.ACT, self.bank, row, 0.0, "bm.act"))
            first_gap = t.trcd
        else:                                           # row miss
            if self._tail_col_op is Op.WR:
                pre_gap = t.twr + t.tbl
            elif self._tail_col_op is Op.RD:
                pre_gap = t.trtp + t.tbl
            else:
                pre_gap = t.tras
            prog.append(Cmd(Op.PRE, self.bank, -1, pre_gap, "bm.pre"))
            prog.append(Cmd(Op.ACT, self.bank, row, t.trp, "bm.act"))
            first_gap = t.trcd
        prog.append(Cmd(col, self.bank, row, first_gap, "bm.col0"))
        for i in range(1, n_bursts):
            prog.append(Cmd(col, self.bank, row, t.tccd_l, f"bm.col{i}"))
        closed = ((not self.open_page) if auto_precharge is None
                  else auto_precharge)
        if closed:                                      # closed-page policy
            tail = t.twr if write else t.trtp + t.tbl
            prog.append(Cmd(Op.PRE, self.bank, -1, tail, "bm.prea"))
        return self.enqueue_program(prog)

    # ------------------------------------------------------------------ #
    # Multiplexer interface
    # ------------------------------------------------------------------ #

    def __len__(self) -> int:
        return len(self.queue)

    def head(self) -> QueuedCmd | None:
        return self.queue[0] if self.queue else None

    def earliest_issue(self) -> float:
        """Per-bank earliest issue time for the head command."""
        q = self.queue[0]
        t = self.floor
        if self.last_issue is not None:
            t = max(t, self.last_issue + q.cmd.min_gap)
        else:
            t = max(t, q.cmd.min_gap)
        return t

    def issue(self, when: float) -> QueuedCmd:
        """Pop the head command; update FSM/open-row state."""
        q = self.queue.popleft()
        self.last_issue = when
        if q.cmd.op is Op.ACT:
            self.state = BankState.ACTIVE
            self.open_row = q.cmd.row
        elif q.cmd.op is Op.PRE:
            self.state = BankState.IDLE
            self.open_row = None
        return q

    def note_refresh(self, lockout_end: float) -> None:
        """A rank REF closed every row; resume no earlier than the lockout
        end, and re-activate if the queued head assumed an open row."""
        self.state = BankState.IDLE
        self.open_row = None
        self.floor = max(self.floor, lockout_end)
        if self.queue:
            q0 = self.queue[0]
            if q0.cmd.op in (Op.RD, Op.WR):
                q0.cmd = dataclasses.replace(q0.cmd, min_gap=self.t.trcd)
                q0.seq_start = False
                self.queue.appendleft(QueuedCmd(
                    Cmd(Op.ACT, self.bank, q0.cmd.row, 0.0, "bm.reopen"),
                    True, q0.seq_id))
