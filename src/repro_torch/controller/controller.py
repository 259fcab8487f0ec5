"""``MemoryController`` — the bank-parallel scheduling facade.

Accepts the existing ``Cmd`` programs (each targeting one bank) and returns a
cycle-accounted :class:`ControllerTrace`, a drop-in ``ScheduleResult`` with
the refresh/bank accounting on top.  A single-bank program schedules to the
exact same issue times as the sequential ``CommandScheduler`` (equivalence is
tested); multi-bank program sets overlap under tFAW/tRRD/tCCD and yield to
REF every tREFI.

:meth:`MemoryController.batch_cost` is the cost-plane entry point: it prices
one *unit* program list replicated across N banks, both as a raw makespan
(bank-parallel speedup, tFAW/tRRD-limited) and amortized over a ≥2·tREFI
steady-state window (refresh interference factor).  The engine uses these
measured factors instead of the old closed-form ``ceil(rows/banks)`` divide.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.controller.bank_machine import BankMachine
from repro_torch.controller.multiplexer import CommandMultiplexer
from repro_torch.controller.refresher import Refresher
from repro_torch.core.commands import Cmd, ScheduleResult
from repro_torch.core.timing import DDR4_2400, DramTimings


def retarget_program(prog, bank: int) -> list[Cmd]:
    """Copy of ``prog`` with every command redirected to ``bank``."""
    return [dataclasses.replace(c, bank=bank) if c.bank != bank else c
            for c in prog]


@dataclasses.dataclass
class ControllerTrace(ScheduleResult):
    """ScheduleResult + the controller's refresh/bank accounting."""
    n_refreshes: int = 0
    refresh_stall_ns: float = 0.0
    refresh_windows: list = dataclasses.field(default_factory=list)
    per_bank_ns: dict = dataclasses.field(default_factory=dict)
    # The timing set the schedule ran under, so ``.counters()`` derives
    # bus-utilization/stall numbers against the right clock.
    timings: DramTimings | None = None


@dataclasses.dataclass(frozen=True)
class BankBatchCost:
    """Measured cost of one unit program replicated across ``banks`` banks."""
    banks: int
    unit_ns: float         # unit scheduled alone on one bank
    makespan_ns: float     # banks concurrent copies, refresh off
    amortized_ns: float    # per batch over a >=2*tREFI window, refresh on
    n_refreshes: int
    refresh_stall_ns: float

    @property
    def parallel_speedup(self) -> float:
        """Effective bank parallelism in [1, banks] (tFAW/tRRD-limited)."""
        if self.makespan_ns <= 0:
            return float(self.banks)
        return self.banks * self.unit_ns / self.makespan_ns

    @property
    def refresh_factor(self) -> float:
        """Steady-state slowdown >= 1 from periodic REF lockouts."""
        if self.makespan_ns <= 0:
            return 1.0
        return max(1.0, self.amortized_ns / self.makespan_ns)


class MemoryController:
    """Bank machines + multiplexer + refresher behind one ``schedule`` call.

    Stateless across calls: every ``schedule`` builds fresh bank machines,
    so the controller can be shared by cost model, engine, and benchmarks.
    """

    def __init__(self, timings: DramTimings = DDR4_2400, n_banks: int = 16,
                 refresh: bool = True, trefi: float | None = None,
                 trfc: float | None = None, postponing: int = 1,
                 open_page: bool = True, lookahead: int = 8):
        self.t = timings
        self.n_banks = n_banks
        self.refresh = refresh
        self.trefi = timings.trefi if trefi is None else trefi
        self.trfc = timings.trfc if trfc is None else trfc
        self.postponing = postponing
        self.open_page = open_page
        # Crossbar command-buffer depth (LiteDRAM cmd_buffer_depth):
        # the default per-bank lookahead schedule_concurrent runs with.
        # Never consulted by the single-stream schedule/batch_cost paths,
        # so it is a pure execution knob (EngineConfig/the autotuner set
        # it as cmd_buffer_lookahead).
        if lookahead < 1:
            raise ValueError(f"lookahead must be >= 1, got {lookahead}")
        self.lookahead = lookahead
        self._batch_cache: dict[tuple, BankBatchCost] = {}

    # ------------------------------------------------------------------ #

    def _machines(self) -> list[BankMachine]:
        return [BankMachine(b, self.t, self.open_page)
                for b in range(self.n_banks)]

    def _refresher(self, enabled: bool) -> Refresher:
        return Refresher(self.t, trefi=self.trefi, trfc=self.trfc,
                         postponing=self.postponing,
                         enabled=enabled and self.refresh)

    @staticmethod
    def _as_programs(programs) -> list[list[Cmd]]:
        if programs and isinstance(programs[0], Cmd):
            return [list(programs)]
        return [list(p) for p in programs]

    def schedule(self, programs, refresh: bool | None = None
                 ) -> ControllerTrace:
        """Schedule one program (flat ``list[Cmd]``) or many programs.

        Each program must target a single bank (its commands' ``bank``
        field); programs for different banks overlap on the command bus.
        """
        progs = self._as_programs(programs)
        machines = self._machines()
        by_id = {bm.bank: bm for bm in machines}
        for prog in progs:
            if not prog:
                continue
            banks = {c.bank for c in prog}
            if len(banks) != 1:
                raise ValueError(
                    f"program spans banks {sorted(banks)}; submit one "
                    f"program per bank")
            bank = prog[0].bank
            if bank not in by_id:
                raise ValueError(f"bank {bank} out of range "
                                 f"(controller has {self.n_banks})")
            by_id[bank].enqueue_program(prog)
        mux = CommandMultiplexer(self.t, machines, self._refresher(
            True if refresh is None else refresh))
        r = mux.run()
        return ControllerTrace(
            total_ns=r.total_ns, energy_j=r.energy_j, n_acts=r.n_acts,
            n_pres=r.n_pres, n_rdwr=r.n_rdwr,
            issue_times=[t for _, t in r.events],
            cmds=[c for c, _ in r.events],
            n_refreshes=r.n_refreshes, refresh_stall_ns=r.refresh_stall_ns,
            refresh_windows=r.refresh_windows, per_bank_ns=r.per_bank_last,
            timings=self.t)

    def schedule_batch(self, unit_programs, banks: int,
                       n_batches: int = 1, refresh: bool | None = None,
                       bank_order: tuple[int, ...] | None = None
                       ) -> ControllerTrace:
        """``n_batches`` copies of the unit program list on each of
        ``banks`` banks (unit programs run back-to-back per bank).

        ``bank_order`` names the physical banks to use and their visit
        order (default: banks 0..banks-1 in index order) — the reliability
        plane passes a calibration-ranked order so batches prefer strong
        banks."""
        if bank_order is None:
            targets = range(banks)
        else:
            targets = list(bank_order)[:banks]
            bad = [b for b in targets if not 0 <= b < self.n_banks]
            if bad or len(set(targets)) != len(targets):
                raise ValueError(
                    f"bank_order must be distinct bank ids < "
                    f"{self.n_banks}, got {list(bank_order)!r}")
        progs = []
        for b in targets:
            for _ in range(n_batches):
                for prog in self._as_programs(unit_programs):
                    progs.append(retarget_program(prog, b))
        return self.schedule(progs, refresh=refresh)

    def schedule_concurrent(self, streams, lookahead: int | None = None,
                            auto_precharge: bool = False,
                            refresh: bool | None = None):
        """Schedule N concurrent client streams through the crossbar.

        ``streams`` is a list of per-client program lists (each program a
        single-bank ``list[Cmd]``, same contract as :meth:`schedule`).
        One :class:`~repro_torch.controller.crossbar.ClientPort` is opened per
        stream; ports contending for a bank are granted round-robin with
        at most ``lookahead`` pending sequences per bank machine (default:
        the controller's own ``lookahead``).  Returns
        a :class:`~repro_torch.controller.crossbar.CrossbarTrace` whose
        ``port_of`` attributes every issued command to its client.

        With a single stream this is byte-for-byte :meth:`schedule`
        (pinned by the golden-trace tests)."""
        from repro_torch.controller.crossbar import Crossbar
        if lookahead is None:
            lookahead = self.lookahead
        xbar = Crossbar(timings=self.t, n_banks=self.n_banks,
                        n_ports=max(1, len(streams)), lookahead=lookahead,
                        auto_precharge=auto_precharge, refresh=self.refresh,
                        trefi=self.trefi, trfc=self.trfc,
                        postponing=self.postponing,
                        open_page=self.open_page)
        for i, progs in enumerate(streams):
            xbar.port(i).submit(progs)
        return xbar.run(refresh=refresh)

    # ------------------------------------------------------------------ #
    # Cost-plane entry point
    # ------------------------------------------------------------------ #

    @staticmethod
    def _signature(progs) -> tuple:
        return tuple(tuple((c.op.value, round(c.min_gap, 6)) for c in p)
                     for p in progs)

    def batch_cost(self, unit_programs, banks: int,
                   bank_order: tuple[int, ...] | None = None
                   ) -> BankBatchCost:
        """Measured bank-parallel + refresh cost of one unit across banks.

        The unit (a list of programs, e.g. one MAJ op's primitive sequences)
        is scheduled (a) alone on one bank, (b) replicated on ``banks``
        banks refresh-free (raw makespan), and (c) repeated until the
        simulated window spans at least two tREFI with refresh on, giving
        the amortized steady-state batch latency.

        Units: all latencies are nanoseconds (DDR4-2400 tCK grid from
        ``core/timing.py``). The returned ``BankBatchCost`` carries the
        dimensionless ``parallel_speedup`` (single-bank time / per-unit
        batch time, <= banks — tFAW/tRRD/bus-limited) and
        ``refresh_factor`` (steady-state slowdown >= 1.0) that
        ``EngineStats.charge`` applies to the closed-form single-bank
        latency; results are cached per (banks, program signature).
        This is the cost plane's only entry point into the controller:
        both eager and fused engine modes price through it identically.
        """
        banks = max(1, min(banks, self.n_banks))
        progs = self._as_programs(unit_programs)
        order = None if bank_order is None else tuple(bank_order)
        key = (banks, order, self._signature(progs))
        if key in self._batch_cache:
            return self._batch_cache[key]
        unit = self.schedule_batch(progs, 1, refresh=False,
                                   bank_order=order).total_ns
        makespan = self.schedule_batch(progs, banks, refresh=False,
                                       bank_order=order).total_ns
        if self.refresh and makespan > 0:
            # Repeat batches until the window spans >= 2 tREFI, then isolate
            # the refresh slowdown by comparing the same window with REF
            # injection on vs off (pipelining across batches cancels out).
            reps = max(2, min(256, math.ceil(
                2 * self.trefi * self.postponing / makespan)))
            t_ref = self.schedule_batch(progs, banks, n_batches=reps,
                                        refresh=True, bank_order=order)
            t_off = self.schedule_batch(progs, banks, n_batches=reps,
                                        refresh=False, bank_order=order)
            factor = max(1.0, t_ref.total_ns / max(t_off.total_ns, 1e-9))
            amortized = makespan * factor
            n_ref, stall = t_ref.n_refreshes, t_ref.refresh_stall_ns
        else:
            amortized, n_ref, stall = makespan, 0, 0.0
        out = BankBatchCost(banks=banks, unit_ns=unit, makespan_ns=makespan,
                            amortized_ns=amortized, n_refreshes=n_ref,
                            refresh_stall_ns=stall)
        self._batch_cache[key] = out
        return out
