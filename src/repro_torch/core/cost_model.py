"""Closed-form cost model for PuM operations (paper §6.1.2, Figs 5/17/18/19).

Latency source of truth: the same command programs the executor issues,
scheduled by the same tFAW/tRRD-aware scheduler — so the closed-form numbers
match the executed traces exactly (cross-checked in tests).

Throughput model (paper's): a MAJ op processes ``row_bits`` bitlines (SIMD
lanes) but only the *stable* fraction (success rate) produces usable results:

    throughput = row_bits * success_rate / latency

The FracDRAM baseline is MAJ3 on a 4-row activation with a per-op Frac
(FracDRAM re-establishes the neutral row each operation); PULSAR picks, per
manufacturer and per fan-in M, the N_RG that maximizes throughput — exactly
the paper's methodology ("we choose the N_RG that produces the highest
throughput").
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import commands as cmds
from repro_torch.core.pulsar import buddy_assign
from repro_torch.core.replication import plan as replication_plan, plan_pow2
from repro_torch.core.timing import DDR4_2400, DramTimings


@dataclasses.dataclass(frozen=True)
class OpCost:
    latency_ns: float
    energy_j: float
    n_sequences: int      # violated-timing row sequences (AAP/APA/Frac/...)

    def __add__(self, other: "OpCost") -> "OpCost":
        return OpCost(self.latency_ns + other.latency_ns,
                      self.energy_j + other.energy_j,
                      self.n_sequences + other.n_sequences)

    def __mul__(self, k: float) -> "OpCost":
        return OpCost(self.latency_ns * k, self.energy_j * k,
                      int(round(self.n_sequences * k)))

    __rmul__ = __mul__


ZERO = OpCost(0.0, 0.0, 0)


class CostModel:
    def __init__(self, timings: DramTimings = DDR4_2400,
                 row_bits: int = 65536, controller=None):
        """``controller``: an optional
        :class:`repro_torch.controller.MemoryController`; when set, primitive
        programs are priced through its bank-machine/multiplexer schedule
        (identical to the sequential path for single-bank programs — the
        equivalence is tested) and multi-bank batches can be priced with
        :meth:`maj_unit_programs` + ``controller.batch_cost``.  ``None``
        keeps the legacy sequential ``CommandScheduler`` path."""
        self.t = timings
        self.row_bits = row_bits
        self._wr_bursts = max(1, row_bits // 512)
        self._sched = cmds.CommandScheduler(timings)
        self.controller = controller
        self._cache: dict[tuple, OpCost] = {}

    # ------------------------------------------------------------------ #
    # Primitive costs (scheduled programs)
    # ------------------------------------------------------------------ #

    def _sched_cost(self, prog) -> OpCost:
        if self.controller is not None:
            r = self.controller.schedule(prog)
        else:
            r = self._sched.schedule(prog)
        return OpCost(r.total_ns, r.energy_j, 1)

    def aap(self) -> OpCost:
        return self._sched_cost(cmds.prog_aap_multi_row_init(0, 0, 1, self.t))

    def apa(self) -> OpCost:
        return self._sched_cost(cmds.prog_apa_charge_share(0, 0, 1, self.t))

    def frac(self, frac_supported: bool = True) -> OpCost:
        if frac_supported:
            return self._sched_cost(cmds.prog_frac(0, 0, self.t))
        # Mfr. M: re-init with the bias pattern via RowClone (one AAP).
        return self.aap()

    def write_row(self) -> OpCost:
        return self._sched_cost(
            cmds.prog_write_row(0, 0, self._wr_bursts, self.t))

    def read_row(self) -> OpCost:
        return self._sched_cost(
            cmds.prog_read_row(0, 0, self._wr_bursts, self.t))

    def bulk_write(self) -> OpCost:
        return self._sched_cost(
            cmds.prog_bulk_write(0, 0, 1, self._wr_bursts, self.t))

    # ------------------------------------------------------------------ #
    # MAJ op with PULSAR staging (mirrors PulsarExecutor.maj exactly)
    # ------------------------------------------------------------------ #

    def maj_op(self, m: int, n_rg: int, frac_supported: bool = True,
               reuse_neutral: bool = False,
               plan_style: str = "pow2",
               resident_inputs: int = 0) -> OpCost:
        """Full MAJ-M at N_RG: copy-ins + fills + neutrals + APA + copy-out.

        ``reuse_neutral``: PULSAR-only optimization — neutral rows are
        re-established lazily (they are consumed by each APA, so the faithful
        default re-Fracs them every op, like the executor does).
        ``plan_style``: mirrors PulsarExecutor.maj.
        ``resident_inputs``: chained-staging (PulsarExecutor.maj
        in_place_input): that many inputs' staging is skipped because the
        previous op's APA left their value resident across the region.
        """
        key = ("maj", m, n_rg, frac_supported, reuse_neutral, plan_style,
               resident_inputs)
        if key in self._cache:
            return self._cache[key]
        rp = (plan_pow2 if plan_style == "pow2" else replication_plan)(m, n_rg)
        k = n_rg.bit_length() - 1
        per_input, neutral_blocks = buddy_assign(m, rp.copies, rp.n_neutral, k)
        cost = ZERO
        for blocks in per_input[resident_inputs:]:
            for _start, size in blocks:
                cost = cost + self.aap()            # copy-in RowClone
                if size > 1:
                    cost = cost + self.aap()        # Multi-RowInit fill
        if not reuse_neutral:
            if frac_supported:
                cost = cost + rp.n_neutral * self.frac(True)
            else:
                # bias-pattern block re-init: seed clone + MRI per block
                for _start, size in neutral_blocks:
                    cost = cost + self.aap()
                    if size > 1:
                        cost = cost + self.aap()
        cost = cost + self.apa()                    # charge share
        cost = cost + self.aap()                    # copy-out
        self._cache[key] = cost
        return cost

    def maj_unit_programs(self, m: int, n_rg: int,
                          frac_supported: bool = True,
                          plan_style: str = "pow2",
                          resident_inputs: int = 0,
                          bank: int = 0) -> list[list[cmds.Cmd]]:
        """The primitive command programs composing one MAJ-M@N_RG op, in
        issue order — the schedulable counterpart of :meth:`maj_op` (same
        sequence count and, scheduled back-to-back on one bank, the same
        latency).  This is the *unit* that ``MemoryController.batch_cost``
        replicates across banks to measure bank-parallel speedup and
        refresh interference."""
        rp = (plan_pow2 if plan_style == "pow2" else replication_plan)(m,
                                                                       n_rg)
        k = n_rg.bit_length() - 1
        per_input, neutral_blocks = buddy_assign(m, rp.copies, rp.n_neutral,
                                                 k)
        t = self.t
        progs: list[list[cmds.Cmd]] = []
        for blocks in per_input[resident_inputs:]:
            for _start, size in blocks:
                progs.append(cmds.prog_aap_multi_row_init(bank, 0, 1, t))
                if size > 1:
                    progs.append(cmds.prog_aap_multi_row_init(bank, 0, 1, t))
        if frac_supported:
            progs.extend(cmds.prog_frac(bank, 0, t)
                         for _ in range(rp.n_neutral))
        else:
            for _start, size in neutral_blocks:
                progs.append(cmds.prog_aap_multi_row_init(bank, 0, 1, t))
                if size > 1:
                    progs.append(cmds.prog_aap_multi_row_init(bank, 0, 1, t))
        progs.append(cmds.prog_apa_charge_share(bank, 0, 1, t))
        progs.append(cmds.prog_aap_multi_row_init(bank, 0, 1, t))
        return progs

    def fracdram_maj3(self) -> OpCost:
        """State-of-the-art baseline [26]: MAJ3 @ N=4 (1 Frac per op)."""
        return self.maj_op(3, 4, frac_supported=True)

    # ------------------------------------------------------------------ #
    # ALU op costs (mirror alu.py synthesis; dual-rail => 2x MAJ count)
    # ------------------------------------------------------------------ #

    def logic2(self, m: int, n_rg: int, **kw) -> OpCost:
        """Elementwise AND/OR of two planes (dual-rail)."""
        return 2 * self.maj_op(m, n_rg, **kw)

    def xor2(self, m: int, n_rg: int, **kw) -> OpCost:
        """XOR = 2 AND + 1 OR, dual-rail."""
        return 6 * self.maj_op(m, n_rg, **kw)

    def full_adder(self, maj_fan_in: int, n_rg: int,
                   n_rg3: int | None = None, chained: bool = False,
                   **kw) -> OpCost:
        """MAJ5 path: Cout pair at its own (cheap) MAJ3 config ``n_rg3``,
        Sum pair at the MAJ5 config ``n_rg``.

        ``chained``: double-buffered regions keep each carry chain resident
        (Cout ops reuse Cin; Sum ops reuse the doubled ¬Cout operand) —
        the chained-staging schedule (EXPERIMENTS.md §Perf P4)."""
        n3 = n_rg3 or (4 if maj_fan_in >= 5 else n_rg)
        r3 = 1 if chained else 0
        if maj_fan_in >= 5:
            r5 = 2 if chained else 0   # the doubled ¬Cout operand
            return (2 * self.maj_op(3, n3, resident_inputs=r3, **kw)
                    + 2 * self.maj_op(5, n_rg, resident_inputs=r5, **kw))
        return (2 * self.maj_op(3, n_rg, resident_inputs=r3, **kw)
                + 4 * self.maj_op(3, n_rg, **kw))

    def add(self, width: int, maj_fan_in: int, n_rg: int,
            n_rg3: int | None = None, chained: bool = False, **kw) -> OpCost:
        return width * self.full_adder(maj_fan_in, n_rg, n_rg3,
                                       chained=chained, **kw)

    def mul(self, width: int, maj_fan_in: int, n_rg: int,
            n_rg3: int | None = None, chained: bool = False, **kw) -> OpCost:
        n3 = n_rg3 or (4 if maj_fan_in >= 5 else n_rg)
        ands = width * width * self.logic2(3, n3, **kw)
        adds = (width - 1) * self.add(width, maj_fan_in, n_rg, n_rg3,
                                      chained=chained, **kw)
        return ands + adds

    def div(self, width: int, maj_fan_in: int, n_rg: int,
            n_rg3: int | None = None, chained: bool = False, **kw) -> OpCost:
        we = width + 1
        n3 = n_rg3 or (4 if maj_fan_in >= 5 else n_rg)
        per_iter = (self.add(we, maj_fan_in, n_rg, n_rg3,
                             chained=chained, **kw)                # sub
                    + 2 * we * self.logic2(3, n3, **kw)           # mux ands
                    + we * self.logic2(3, n3, **kw)               # mux or
                    + 2 * self.aap())                             # q-bit clones
        return width * per_iter

    @staticmethod
    def tree_nodes(n_inputs: int, fan_in: int) -> int:
        nodes, level = 0, n_inputs
        while level > 1:
            full, rem = divmod(level, fan_in)
            nodes += full + (1 if rem > 1 else 0)
            level = full + (1 if rem else 0)
        return nodes

    def reduce_tree(self, n_planes: int, maj_fan_in: int, n_rg: int,
                    chained: bool = False, **kw) -> OpCost:
        """AND/OR reduction over n_planes with fan-in (M+1)/2 nodes.
        ``chained``: internal nodes keep one input (the spine: the previous
        node's output) resident in the region."""
        f = (maj_fan_in + 1) // 2
        nodes = self.tree_nodes(n_planes, f)
        leaves_level = -(-n_planes // f)
        internal = max(0, nodes - leaves_level)
        r = 1 if chained else 0
        return (leaves_level * 2 * self.maj_op(maj_fan_in, n_rg, **kw)
                + internal * 2 * self.maj_op(maj_fan_in, n_rg,
                                             resident_inputs=r, **kw))

    def xor_reduce(self, n_planes: int, maj_fan_in: int, n_rg: int,
                   chained: bool = False, **kw) -> OpCost:
        per = self.xor2(min(3, maj_fan_in), n_rg, **kw)
        if chained:
            # the final OR of each XOR chains one AND output in-region.
            per = (4 * self.maj_op(3, n_rg, **kw)
                   + 2 * self.maj_op(3, n_rg, resident_inputs=1, **kw))
        return (n_planes - 1) * per

    # ------------------------------------------------------------------ #
    # Microbenchmark suite (Fig 17): per-element costs on two w-bit vectors
    # ------------------------------------------------------------------ #

    def microbench(self, name: str, maj_fan_in: int, n_rg: int,
                   width: int = 32, **kw) -> OpCost:
        m, n = maj_fan_in, n_rg
        if name in ("and", "or"):
            return self.reduce_tree(2 * width, m, n, **kw)
        if name == "xor":
            return self.xor_reduce(2 * width, m, n, **kw)
        if name == "add":
            return self.add(width, m, n, **kw)
        if name == "sub":
            return self.add(width, m, n, **kw)
        if name == "mul":
            return self.mul(width, m, n, **kw)
        if name == "div":
            return self.div(width, m, n, **kw)
        raise KeyError(name)


MICROBENCHES = ("and", "or", "xor", "add", "sub", "mul", "div")


def throughput_elems_per_s(cost: OpCost, row_bits: int,
                           success_rate: float = 1.0) -> float:
    """Usable elements per second: stable lanes / latency (paper's metric)."""
    if cost.latency_ns <= 0:
        return float("inf")
    return row_bits * success_rate / (cost.latency_ns * 1e-9)
