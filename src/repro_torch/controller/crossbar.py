"""Client crossbar (LiteDRAM ``crossbar.py`` analogue, PULSAR serve tier).

N concurrent client streams share one rank through per-client
:class:`ClientPort` objects.  Each port demuxes its requests into
per-(port, bank) FIFOs; the crossbar feeds the existing per-bank
:class:`~repro_torch.controller.bank_machine.BankMachine` FSMs through the
multiplexer's ``feeder`` hook, topping each bank up to a configurable
*lookahead* depth of pending sequences (LiteDRAM's
``cmd_buffer_lookahead``).  Arbitration between ports contending for the
same bank is round-robin per bank, so no port can be starved while it has
work queued; rank-wide tFAW/tRRD/tCCD/bus constraints and refresh priority
stay entirely in :class:`~repro_torch.controller.multiplexer.CommandMultiplexer`,
untouched.

Two request kinds per port:

  * :meth:`ClientPort.submit` — PuM command programs (violated-timing
    sequences, the atomic unit refresh may not split), exactly what
    ``MemoryController.schedule`` accepts;
  * :meth:`ClientPort.submit_access` — nominal row accesses priced under
    the page policy.  With ``auto_precharge=True`` the crossbar peeks at
    the *next* queued access for the bank (across all ports, in grant
    order): if it targets a different row, the closing PRE is appended to
    this access up front instead of being paid as a row-miss conflict.

Single-client equivalence: with one port, eager refill reproduces the
exact bank-machine queues ``MemoryController.schedule`` would have built,
so the multiplexer makes identical decisions and the trace is
byte-for-byte the legacy schedule (pinned by the golden-trace tests).

>>> from repro_torch.controller import Crossbar
>>> from repro_torch.core.commands import Cmd, Op
>>> xb = Crossbar(n_ports=2, refresh=False)
>>> prog = [Cmd(Op.ACT, 0, 5, 0.0), Cmd(Op.PRE, 0, -1, 10.0)]
>>> xb.port(0).submit([prog])
>>> xb.port(1).submit([[Cmd(Op.ACT, 1, 7, 0.0), Cmd(Op.PRE, 1, -1, 10.0)]])
>>> tr = xb.run()
>>> sorted(set(tr.port_of))
[0, 1]
>>> len(tr.cmds) == len(tr.port_of) == 4
True
"""

from __future__ import annotations

import dataclasses
from collections import deque

from repro_torch.controller.bank_machine import BankMachine
from repro_torch.controller.controller import ControllerTrace
from repro_torch.controller.multiplexer import CommandMultiplexer
from repro_torch.controller.refresher import Refresher
from repro_torch.core.commands import Cmd
from repro_torch.core.timing import DDR4_2400, DramTimings


@dataclasses.dataclass(frozen=True)
class _Access:
    """A nominal row access waiting in a port's per-bank FIFO."""
    row: int
    write: bool
    n_bursts: int


class ClientPort:
    """One client's submission endpoint: per-bank FIFOs of requests.

    Order is preserved per (port, bank) — requests a client submits to the
    same bank issue in submission order; requests to different banks may
    overlap freely (that is the point of the crossbar)."""

    def __init__(self, xbar: "Crossbar", port_id: int):
        self.xbar = xbar
        self.port = port_id
        # bank -> FIFO of list[Cmd] (program) | _Access
        self.queues: list[deque] = [deque() for _ in range(xbar.n_banks)]

    def __len__(self) -> int:
        return sum(len(q) for q in self.queues)

    def submit(self, programs) -> None:
        """Queue PuM command programs (one bank each, like ``schedule``)."""
        if programs and isinstance(programs[0], Cmd):
            programs = [list(programs)]
        for prog in programs:
            prog = list(prog)
            if not prog:
                continue
            banks = {c.bank for c in prog}
            if len(banks) != 1:
                raise ValueError(
                    f"program spans banks {sorted(banks)}; submit one "
                    f"program per bank")
            bank = prog[0].bank
            self._check_bank(bank)
            self.queues[bank].append(prog)

    def submit_access(self, bank: int, row: int, write: bool = False,
                      n_bursts: int = 1) -> None:
        """Queue a nominal row access (priced by the bank's page policy)."""
        self._check_bank(bank)
        self.queues[bank].append(_Access(row, write, n_bursts))

    def _check_bank(self, bank: int) -> None:
        if not 0 <= bank < self.xbar.n_banks:
            raise ValueError(f"bank {bank} out of range "
                             f"(crossbar has {self.xbar.n_banks})")


@dataclasses.dataclass
class CrossbarTrace(ControllerTrace):
    """ControllerTrace + per-command client-port attribution."""
    # Parallel to ``cmds``/``issue_times``: the port that submitted the
    # sequence each command belongs to, and the (bank, seq_id) identity of
    # that sequence (for atomicity audits against refresh windows).
    port_of: list[int] = dataclasses.field(default_factory=list)
    seqs: list = dataclasses.field(default_factory=list)
    n_ports: int = 1

    def counters(self, timings: DramTimings | None = None):
        """Controller counters + per-port arbitration counters
        (grant counts, starvation gaps) — both pure audit-trail replays."""
        from repro_torch.telemetry import (derive_controller_counters,
                                     derive_port_counters)
        bank = derive_controller_counters(self, timings)
        bank.merge(derive_port_counters(self))
        return bank


class Crossbar:
    """Port demux + lookahead feeder over the existing bank machines.

    ``lookahead`` bounds how many *sequences* may sit in a bank machine's
    queue at once; the feeder refills lazily as the multiplexer drains, so
    a port submitting an unbounded stream cannot monopolize a bank queue —
    later-arriving ports get interleaved within ``lookahead`` sequences.
    """

    def __init__(self, timings: DramTimings = DDR4_2400, n_banks: int = 16,
                 n_ports: int = 2, lookahead: int = 8,
                 auto_precharge: bool = False, refresh: bool = True,
                 trefi: float | None = None, trfc: float | None = None,
                 postponing: int = 1, open_page: bool = True):
        if n_ports < 1:
            raise ValueError(f"n_ports must be >= 1, got {n_ports}")
        if lookahead < 1:
            raise ValueError(f"lookahead must be >= 1, got {lookahead}")
        self.t = timings
        self.n_banks = n_banks
        self.n_ports = n_ports
        self.lookahead = lookahead
        self.auto_precharge = auto_precharge
        self.refresh = refresh
        self.trefi = timings.trefi if trefi is None else trefi
        self.trfc = timings.trfc if trfc is None else trfc
        self.postponing = postponing
        self.open_page = open_page
        self.ports = [ClientPort(self, p) for p in range(n_ports)]

    def port(self, i: int) -> ClientPort:
        return self.ports[i]

    # ------------------------------------------------------------------ #

    @staticmethod
    def _pending_seqs(bm: BankMachine) -> int:
        return sum(1 for q in bm.queue if q.seq_start)

    def _next_row(self, bank: int, rr: int) -> int | None:
        """Row of the next access the feeder would grant for ``bank``
        (None if the next request is a raw program or nothing is queued).
        Drives lookahead auto-precharge."""
        for off in range(self.n_ports):
            q = self.ports[(rr + off) % self.n_ports].queues[bank]
            if q:
                head = q[0]
                return head.row if isinstance(head, _Access) else None
        return None

    def run(self, refresh: bool | None = None) -> CrossbarTrace:
        """Drain every port through the shared multiplexer.

        Stateless like ``MemoryController.schedule``: fresh bank machines
        and refresher per call; the ports' queues are consumed."""
        machines = [BankMachine(b, self.t, self.open_page)
                    for b in range(self.n_banks)]
        refresher = Refresher(
            self.t, trefi=self.trefi, trfc=self.trfc,
            postponing=self.postponing,
            enabled=self.refresh if refresh is None else refresh)
        # Per-bank round-robin pointer over ports (grant fairness) and
        # (bank, seq_id) -> port attribution for the audit trail.
        rr = [0] * self.n_banks
        seq_port: dict[tuple[int, int], int] = {}

        def feed() -> None:
            for b, bm in enumerate(machines):
                while self._pending_seqs(bm) < self.lookahead:
                    chosen = -1
                    for off in range(self.n_ports):
                        p = (rr[b] + off) % self.n_ports
                        if self.ports[p].queues[b]:
                            chosen = p
                            break
                    if chosen < 0:
                        break
                    req = self.ports[chosen].queues[b].popleft()
                    if isinstance(req, _Access):
                        apre = None
                        if self.auto_precharge:
                            nxt = self._next_row(b, (chosen + 1)
                                                 % self.n_ports)
                            apre = nxt is not None and nxt != req.row
                        sid = bm.enqueue_access(req.row, req.write,
                                                req.n_bursts,
                                                auto_precharge=apre)
                    else:
                        sid = bm.enqueue_program(req)
                    seq_port[(b, sid)] = chosen
                    rr[b] = (chosen + 1) % self.n_ports

        mux = CommandMultiplexer(self.t, machines, refresher, feeder=feed)
        r = mux.run()
        port_of = [seq_port[key] for key in r.seqs]
        return CrossbarTrace(
            total_ns=r.total_ns, energy_j=r.energy_j, n_acts=r.n_acts,
            n_pres=r.n_pres, n_rdwr=r.n_rdwr,
            issue_times=[t for _, t in r.events],
            cmds=[c for c, _ in r.events],
            n_refreshes=r.n_refreshes, refresh_stall_ns=r.refresh_stall_ns,
            refresh_windows=r.refresh_windows, per_bank_ns=r.per_bank_last,
            timings=self.t, port_of=port_of, seqs=list(r.seqs),
            n_ports=self.n_ports)
