"""CounterBank + post-hoc controller counter derivation.

The port's copy of ``repro.telemetry.counters``. The observability
contract is *derive, don't instrument the scheduler*: the controller's
hot loop stays byte-identical whether or not anyone is watching, and
every controller counter (``derive_controller_counters``,
``derive_port_counters``, ``check_timing_invariants``) is computed after
the fact from the ``cmds``/``issue_times`` audit trail the multiplexer
already emits. :class:`CounterBank` is the one counter container: engine
flush counters and the derived controller counters render through the
same ``as_dict()``/``__repr__`` schema as the reference's.

Units: every counter name carries its unit as a suffix where one applies
(``*_ns`` nanoseconds, ``*_j`` joules); unsuffixed counters are plain
event counts. Histogram observations are raw values bucketed by power of
two (``observe``).
"""

from __future__ import annotations

import math
from collections import deque


class CounterBank:
    """Named monotonic counters plus power-of-two value histograms.

    ``inc(name, v)`` accumulates a counter; ``observe(name, v)`` records a
    sample into a histogram (count / total / min / max / log2 buckets —
    the shape a latency distribution needs without storing samples).
    Everything renders through :meth:`as_dict` with plain-JSON types.
    """

    __slots__ = ("_counters", "_hists")

    def __init__(self):
        self._counters: dict[str, float] = {}
        self._hists: dict[str, dict] = {}

    # -- counters ------------------------------------------------------- #

    def inc(self, name: str, value: float = 1) -> None:
        self._counters[name] = self._counters.get(name, 0) + value

    def get(self, name: str, default: float = 0) -> float:
        return self._counters.get(name, default)

    def __getitem__(self, name: str) -> float:
        return self._counters[name]

    def __contains__(self, name: str) -> bool:
        return name in self._counters

    def __len__(self) -> int:
        return len(self._counters) + len(self._hists)

    # -- histograms ----------------------------------------------------- #

    def observe(self, name: str, value: float) -> None:
        """Record one sample into the ``name`` histogram (log2 buckets:
        bucket ``k`` counts samples in ``(2**(k-1), 2**k]``; non-positive
        samples land in bucket 0)."""
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = {"count": 0, "total": 0.0,
                                     "min": math.inf, "max": -math.inf,
                                     "buckets": {}}
        h["count"] += 1
        h["total"] += value
        h["min"] = min(h["min"], value)
        h["max"] = max(h["max"], value)
        k = 0 if value <= 1 else math.ceil(math.log2(value))
        h["buckets"][k] = h["buckets"].get(k, 0) + 1

    def histogram(self, name: str) -> dict:
        """Snapshot of one histogram: ``count``/``total``/``min``/``max``/
        ``mean``/``buckets`` (bucket key = log2 upper bound)."""
        h = self._hists[name]
        return dict(h, mean=(h["total"] / h["count"] if h["count"] else 0.0),
                    buckets=dict(h["buckets"]))

    # -- windows -------------------------------------------------------- #

    def snapshot(self) -> "CounterBank":
        """An independent deep copy of the bank's current state — the
        start marker of a measurement window (pair with :meth:`delta`).
        Mutating either bank afterwards never affects the other."""
        s = CounterBank()
        s._counters = dict(self._counters)
        # Iterate over copies: the online autotuner takes windows on the
        # flush worker while other threads record into the bank.
        s._hists = {name: {"count": h["count"], "total": h["total"],
                           "min": h["min"], "max": h["max"],
                           "buckets": dict(h["buckets"])}
                    for name, h in list(self._hists.items())}
        return s

    def delta(self, prev: "CounterBank") -> "CounterBank":
        """This bank minus an earlier :meth:`snapshot` — the counters a
        window accumulated, without resetting the live bank (so
        long-lived devices can be profiled per window: the autotuner's
        drift windows are exactly these deltas). Counters subtract;
        histograms subtract count/total/buckets (their ``mean`` stays
        exact); a window's true ``min``/``max`` are not recoverable from
        two cumulative states, so the live bank's values are kept.
        Zero-change entries are dropped."""
        out = CounterBank()
        for name, v in list(self._counters.items()):
            dv = v - prev._counters.get(name, 0)
            if dv:
                out._counters[name] = dv
        for name, h in list(self._hists.items()):
            p = prev._hists.get(name)
            count = h["count"] - (p["count"] if p else 0)
            if not count:
                continue
            buckets = dict(h["buckets"])
            if p:
                for k, n in p["buckets"].items():
                    buckets[k] = buckets.get(k, 0) - n
            out._hists[name] = {
                "count": count,
                "total": h["total"] - (p["total"] if p else 0.0),
                "min": h["min"], "max": h["max"],
                "buckets": {k: n for k, n in buckets.items() if n},
            }
        return out

    def clear(self) -> None:
        """Reset every counter and histogram **in place** (holders of a
        reference to this bank — the engine, an attached reliability
        plane — keep writing into the same object)."""
        self._counters.clear()
        self._hists.clear()

    # -- aggregate views ------------------------------------------------ #

    def merge(self, other: "CounterBank") -> "CounterBank":
        """Accumulate ``other`` into this bank (counters add; histograms
        combine bucket-wise). Returns self for chaining."""
        for name, v in other._counters.items():
            self.inc(name, v)
        for name, h in other._hists.items():
            mine = self._hists.get(name)
            if mine is None:
                self._hists[name] = {"count": h["count"], "total": h["total"],
                                     "min": h["min"], "max": h["max"],
                                     "buckets": dict(h["buckets"])}
            else:
                mine["count"] += h["count"]
                mine["total"] += h["total"]
                mine["min"] = min(mine["min"], h["min"])
                mine["max"] = max(mine["max"], h["max"])
                for k, n in h["buckets"].items():
                    mine["buckets"][k] = mine["buckets"].get(k, 0) + n
        return self

    def as_dict(self) -> dict:
        """Plain-JSON snapshot: ``{"counters": {...}, "histograms": {...}}``
        (the schema ``BENCH_*.json`` embeds and ``docs/observability.md``
        documents)."""
        return {
            "counters": dict(sorted(self._counters.items())),
            "histograms": {name: self.histogram(name)
                           for name in sorted(self._hists)},
        }

    def __repr__(self) -> str:
        parts = [f"{k}={v:g}" for k, v in sorted(self._counters.items())]
        parts += [f"{k}=hist(n={h['count']})"
                  for k, h in sorted(self._hists.items())]
        body = ", ".join(parts[:8]) + (", ..." if len(parts) > 8 else "")
        return f"CounterBank({body})"


# --------------------------------------------------------------------- #
# Post-hoc controller counter derivation
# --------------------------------------------------------------------- #


def derive_controller_counters(result, timings=None) -> CounterBank:
    """Derive controller counters from a scheduled command trace.

    ``result`` is anything carrying the audit trail — a
    ``ScheduleResult`` (``cmds`` + ``issue_times``), a ``MuxResult``
    (``events``), or a ``ControllerTrace`` (which adds refresh
    accounting). Derivation is pure: the trace is only read, so the
    schedule stays byte-identical whether or not counters are derived
    (tested in tests/telemetry).

    Counters produced (units in the name):

    * ``cmd.act`` / ``cmd.pre`` / ``cmd.rdwr`` / ``cmd.nop`` /
      ``cmd.total`` — commands issued per type (``total`` excludes NOPs,
      which never occupy the command bus).
    * ``wall_ns`` — schedule makespan (last issue time).
    * ``cmd_bus_busy_ns`` — command-bus occupancy (one tCK per non-NOP
      command); ``cmd_bus_utilization`` = busy / wall.
    * ``data_bus_busy_ns`` — data-bus occupancy (one tBL burst per
      RD/WR); ``data_bus_utilization`` = busy / wall.
    * ``row.hit`` / ``row.miss`` / ``row.conflict`` — per column command:
      *hit* = no ACT needed since the previous column on that bank (the
      row was already latched), *miss* = an ACT on an idle bank preceded
      it, *conflict* = the preceding ACT re-opened a bank whose last PRE
      closed a *different* row. Also emitted per bank as
      ``bank<N>.row_{hit,miss,conflict}``.
    * ``stall.trrd_ns`` / ``stall.tfaw_ns`` — ACT issue delay beyond the
      bank's own readiness attributable to rank-wide tRRD spacing and to
      the rolling four-activation window.
    * ``refresh.n`` / ``refresh.lockout_ns`` / ``refresh.stall_ns`` —
      REF accounting, when the trace carries it (``ControllerTrace``).
    * ``energy_j`` — when the trace carries it.

    ``timings`` defaults to the trace's own ``timings`` attribute when it
    has one (``MuxResult``/``ControllerTrace``), else DDR4-2400.
    """
    from repro_torch.core.commands import Op

    if timings is None:
        timings = getattr(result, "timings", None)
    if timings is None:
        from repro_torch.core.timing import DDR4_2400
        timings = DDR4_2400
    t = timings

    events = list(result.events)
    bank = CounterBank()
    n_act = n_pre = n_rdwr = n_nop = 0

    # Per-bank open-row replay for hit/miss/conflict classification, and
    # per-bank last-issue for stall attribution.
    open_row: dict[int, int | None] = {}   # bank -> latched row
    closed_row: dict[int, int] = {}        # bank -> row its last PRE closed
    col_kind: dict[int, str] = {}     # bank -> classification of next column
    last_bank_issue: dict[int, float] = {}
    faw: deque[float] = deque()
    last_act = -math.inf
    trrd_stall = tfaw_stall = 0.0

    for cmd, when in events:
        if cmd.op is Op.ACT:
            # Stall attribution: delay past the bank's own readiness,
            # credited first to tRRD spacing, then to the tFAW window
            # (matching the order the multiplexer applies them).
            prev = last_bank_issue.get(cmd.bank)
            ready = cmd.min_gap if prev is None else prev + cmd.min_gap
            trrd_ready = last_act + t.trrd_s
            tfaw_ready = faw[0] + t.tfaw if len(faw) >= 4 else -math.inf
            trrd_stall += max(0.0, min(when, trrd_ready) - ready)
            tfaw_stall += max(0.0,
                              min(when, tfaw_ready) - max(ready, trrd_ready))
            if len(faw) >= 4:
                faw.popleft()
            faw.append(when)
            last_act = when
            n_act += 1
            # Row-buffer classification for the next column command: an
            # ACT on an idle bank is a miss; an ACT re-opening a bank
            # whose last PRE closed a different row is a conflict.
            prev_row = closed_row.get(cmd.bank)
            col_kind[cmd.bank] = ("conflict" if prev_row is not None
                                  and prev_row != cmd.row else "miss")
            open_row[cmd.bank] = cmd.row
        elif cmd.op is Op.PRE:
            n_pre += 1
            if open_row.get(cmd.bank) is not None:
                closed_row[cmd.bank] = open_row[cmd.bank]
            open_row[cmd.bank] = None
        elif cmd.op in (Op.RD, Op.WR):
            n_rdwr += 1
            kind = col_kind.pop(cmd.bank, "hit")
            bank.inc(f"row.{kind}")
            bank.inc(f"bank{cmd.bank}.row_{kind}")
        else:
            n_nop += 1
        if cmd.op is not Op.NOP:
            last_bank_issue[cmd.bank] = when

    wall = events[-1][1] if events else 0.0
    n_total = n_act + n_pre + n_rdwr
    bank.inc("cmd.act", n_act)
    bank.inc("cmd.pre", n_pre)
    bank.inc("cmd.rdwr", n_rdwr)
    bank.inc("cmd.nop", n_nop)
    bank.inc("cmd.total", n_total)
    bank.inc("wall_ns", wall)
    bank.inc("cmd_bus_busy_ns", n_total * t.tck)
    bank.inc("data_bus_busy_ns", n_rdwr * t.tbl)
    if wall > 0:
        bank.inc("cmd_bus_utilization", n_total * t.tck / wall)
        bank.inc("data_bus_utilization", n_rdwr * t.tbl / wall)
    bank.inc("stall.trrd_ns", trrd_stall)
    bank.inc("stall.tfaw_ns", tfaw_stall)

    energy = getattr(result, "energy_j", None)
    if energy is not None:
        bank.inc("energy_j", energy)
    n_ref = getattr(result, "n_refreshes", None)
    if n_ref is not None:
        bank.inc("refresh.n", n_ref)
        bank.inc("refresh.lockout_ns",
                 sum(e - s for s, e in
                     getattr(result, "refresh_windows", ())))
        bank.inc("refresh.stall_ns",
                 getattr(result, "refresh_stall_ns", 0.0))
    return bank


def derive_port_counters(trace) -> CounterBank:
    """Derive per-client-port arbitration counters from a crossbar trace.

    ``trace`` is a ``CrossbarTrace`` (or anything carrying ``events``,
    ``port_of``, ``seqs``, ``n_ports``). Like
    :func:`derive_controller_counters`, this is a pure replay of the
    audit trail — the crossbar's grant decisions are attributed after
    the fact, never instrumented in the arbitration loop.

    Counters produced:

    * ``xbar.n_ports`` — port count of the trace.
    * ``port<P>.cmds`` — non-NOP commands attributed to port P.
    * ``port<P>.seqs`` — sequences (atomic grant units) port P won.
    * ``port<P>.grant_gap_max_ns`` — the longest interval between two
      consecutive sequence *starts* granted to port P while P still had
      later work (the starvation bound: round-robin arbitration keeps
      this finite for any port with queued requests).
    """
    from repro_torch.core.commands import Op

    bank = CounterBank()
    n_ports = int(getattr(trace, "n_ports", 1))
    bank.inc("xbar.n_ports", n_ports)
    events = list(trace.events)
    port_of = list(getattr(trace, "port_of", ()))
    seqs = list(getattr(trace, "seqs", ()))
    cmds = [0] * n_ports
    seq_seen: set = set()
    seq_count = [0] * n_ports
    # Sequence-start grant times per port, in issue order.
    grant_times: list[list[float]] = [[] for _ in range(n_ports)]
    for (cmd, when), p, sq in zip(events, port_of, seqs):
        if cmd.op is not Op.NOP:
            cmds[p] += 1
        if sq not in seq_seen:
            seq_seen.add(sq)
            seq_count[p] += 1
            grant_times[p].append(when)
    for p in range(n_ports):
        bank.inc(f"port{p}.cmds", cmds[p])
        bank.inc(f"port{p}.seqs", seq_count[p])
        gaps = [b - a for a, b in zip(grant_times[p], grant_times[p][1:])]
        bank.inc(f"port{p}.grant_gap_max_ns", max(gaps, default=0.0))
    return bank


def check_timing_invariants(result, timings=None,
                            eps: float = 1e-6) -> list[str]:
    """Audit a scheduled command trace against the rank-wide DRAM timing
    contract. Returns a list of human-readable violation strings — empty
    means the schedule is clean.

    Pure post-hoc replay (same audit trail as
    :func:`derive_controller_counters`); checks exactly the constraints
    ``CommandMultiplexer._rank_constraints`` enforces, independently
    re-derived so a scheduler bug cannot hide in shared code:

    * **tRRD_S** — consecutive ACTs (any banks) at least ``trrd_s``
      apart;
    * **tFAW** — any four consecutive ACTs span at least ``tfaw``
      (rolling window);
    * **tCCD_S** — consecutive column (RD/WR) commands at least
      ``tccd_s`` apart;
    * **bus tCK** — consecutive non-NOP commands at least one ``tck``
      apart (one command bus);
    * **refresh lockout** — no command issues strictly inside a refresh
      window, and no sequence straddles one (in-flight sequences drain
      before the rank is granted to the refresher) — checked when the
      trace carries ``refresh_windows`` (and ``seqs`` for atomicity).

    ``eps`` absorbs float rounding in the ns-domain event times.
    """
    from repro_torch.core.commands import Op

    if timings is None:
        timings = getattr(result, "timings", None)
    if timings is None:
        from repro_torch.core.timing import DDR4_2400
        timings = DDR4_2400
    t = timings

    events = list(result.events)
    violations: list[str] = []
    acts: deque[float] = deque(maxlen=4)
    last_act = last_col = last_bus = None
    for i, (cmd, when) in enumerate(events):
        if cmd.op is Op.ACT:
            if last_act is not None and when - last_act < t.trrd_s - eps:
                violations.append(
                    f"tRRD: ACT@{when:.3f} (bank {cmd.bank}) only "
                    f"{when - last_act:.3f} ns after previous ACT "
                    f"(< {t.trrd_s})")
            if len(acts) == 4 and when - acts[0] < t.tfaw - eps:
                violations.append(
                    f"tFAW: ACT@{when:.3f} (bank {cmd.bank}) is the 5th "
                    f"ACT within {when - acts[0]:.3f} ns (< {t.tfaw})")
            acts.append(when)
            last_act = when
        elif cmd.op in (Op.RD, Op.WR):
            if last_col is not None and when - last_col < t.tccd_s - eps:
                violations.append(
                    f"tCCD: {cmd.op.name}@{when:.3f} (bank {cmd.bank}) "
                    f"only {when - last_col:.3f} ns after previous "
                    f"column command (< {t.tccd_s})")
            last_col = when
        if cmd.op is not Op.NOP:
            if last_bus is not None and when - last_bus < t.tck - eps:
                violations.append(
                    f"bus: {cmd.op.name}@{when:.3f} (bank {cmd.bank}) "
                    f"only {when - last_bus:.3f} ns after previous "
                    f"command (< tCK {t.tck})")
            last_bus = when

    windows = list(getattr(result, "refresh_windows", ()) or ())
    if windows:
        for cmd, when in events:
            if cmd.op is Op.NOP:
                continue
            for start, end in windows:
                if start + eps < when < end - eps:
                    violations.append(
                        f"refresh: {cmd.op.name}@{when:.3f} (bank "
                        f"{cmd.bank}) issued inside refresh lockout "
                        f"[{start:.3f}, {end:.3f}]")
        seqs = list(getattr(result, "seqs", ()) or ())
        if len(seqs) == len(events):
            span: dict = {}
            for sq, (_, when) in zip(seqs, events):
                s = span.setdefault(sq, [when, when])
                s[0] = min(s[0], when)
                s[1] = max(s[1], when)
            for sq, (s0, s1) in span.items():
                for start, end in windows:
                    if s0 < start - eps and s1 > start + eps:
                        violations.append(
                            f"refresh: sequence {sq} straddles the "
                            f"lockout starting at {start:.3f} "
                            f"(spans [{s0:.3f}, {s1:.3f}])")
    return violations
