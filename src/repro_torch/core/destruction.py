"""Cold-boot-attack content destruction (paper §6.2, Fig 19).

The port's copy of ``repro.core.destruction``: the same command sequences
(so the same ``DestructionReport``) on a chip whose bank payload lies on a
torch device.

Destroys a bank's contents by overwriting every row, using:
  * RowClone baseline [25]: 1 WR (pattern row) + one AAP per row,
  * FracDRAM baseline [26]: one Frac per row (rows left at VDD/2),
  * PULSAR: Bulk-Write seeds 2^k rows in one shot, then Multi-RowInit
    greedily covers the bank with the largest available activation blocks
    (each APA covers up to max_rows rows; the greedy N_RG cover issues the
    fewest sequences).

Both the *logical effect* (every row overwritten — verified on the chip
model in tests) and the *latency* (command scheduler) are produced.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.chip import PulsarChip
from repro_torch.core.cost_model import CostModel, OpCost
from repro_torch.core.pulsar import PulsarExecutor


@dataclasses.dataclass
class DestructionReport:
    method: str
    n_sequences: int
    latency_ns: float
    energy_j: float
    rows_destroyed: int

    @property
    def latency_ms(self) -> float:
        return self.latency_ns * 1e-6


def plan_pulsar_cover(rows_per_subarray: int, n_subarrays: int,
                      max_block: int) -> list[int]:
    """Greedy block sizes covering one bank: per subarray, repeatedly take
    the largest power-of-two activation block that fits the remainder."""
    blocks = []
    for _ in range(n_subarrays):
        remaining = rows_per_subarray
        while remaining:
            b = min(max_block, 1 << (remaining.bit_length() - 1))
            blocks.append(b)
            remaining -= b
    return blocks


def pulsar_destruction_cost(cost: CostModel, rows_per_subarray: int,
                            n_subarrays: int, max_block: int) -> OpCost:
    blocks = plan_pulsar_cover(rows_per_subarray, n_subarrays, max_block)
    total = cost.bulk_write()  # seed the pattern into the first block
    for b in blocks:
        if b == 1:
            total = total + cost.aap()          # lone row: RowClone
        else:
            total = total + cost.aap()          # Multi-RowInit block
    return total


def rowclone_destruction_cost(cost: CostModel, n_rows: int) -> OpCost:
    return cost.write_row() + n_rows * cost.aap()


def fracdram_destruction_cost(cost: CostModel, n_rows: int) -> OpCost:
    return n_rows * cost.frac(True)


def destroy_bank_pulsar(chip: PulsarChip, bank: int,
                        pattern: int = 0) -> DestructionReport:
    """Execute PULSAR-based destruction on the chip model (verifiable)."""
    g = chip.geometry
    start_ops = chip.stats.n_ops
    start_lat = chip.stats.latency_ns
    start_e = chip.stats.energy_j
    data = np.full(g.words_per_row, pattern, np.uint32)
    for sa in range(g.subarrays_per_bank):
        x = PulsarExecutor(chip, bank, sa)
        max_block = x.max_n_rg()
        base = sa * g.rows_per_subarray
        covered: set[int] = set()
        # Seed with one Bulk-Write on the largest block.
        rows = x.bulk_write_block(data, max_block)
        covered.update(rows)
        seed_row = rows[0]
        # Greedy Multi-RowInit cover: walk remaining rows; for each uncovered
        # row, activate the largest block anchored near it.
        for r in range(base, base + g.rows_per_subarray):
            if r in covered:
                continue
            done = False
            b = max_block
            while b >= 2 and not done:
                try:
                    rf, rs = chip.decoder.find_group_pair(
                        sa, b, include=(r,))
                    got = set(chip.decoder.activated_rows(rf, rs))
                    if r in got:
                        chip.row_clone(bank, seed_row, rf)
                        chip.multi_row_init(bank, rf, rs)
                        covered.update(got)
                        covered.add(rf)
                        done = True
                except ValueError:
                    pass
                b >>= 1
            if not done:
                chip.row_clone(bank, seed_row, r)
                covered.add(r)
    return DestructionReport(
        method="pulsar",
        n_sequences=chip.stats.n_ops - start_ops,
        latency_ns=chip.stats.latency_ns - start_lat,
        energy_j=chip.stats.energy_j - start_e,
        rows_destroyed=g.rows_per_bank)


def destroy_bank_rowclone(chip: PulsarChip, bank: int,
                          pattern: int = 0) -> DestructionReport:
    g = chip.geometry
    start_ops, start_lat, start_e = (chip.stats.n_ops, chip.stats.latency_ns,
                                     chip.stats.energy_j)
    data = np.full(g.words_per_row, pattern, np.uint32)
    chip.write_row(bank, 0, data)
    for r in range(1, g.rows_per_bank):
        chip.row_clone(bank, 0, r)
    return DestructionReport(
        "rowclone", chip.stats.n_ops - start_ops,
        chip.stats.latency_ns - start_lat, chip.stats.energy_j - start_e,
        g.rows_per_bank)


def destroy_bank_fracdram(chip: PulsarChip, bank: int) -> DestructionReport:
    g = chip.geometry
    start_ops, start_lat, start_e = (chip.stats.n_ops, chip.stats.latency_ns,
                                     chip.stats.energy_j)
    for r in range(g.rows_per_bank):
        chip.frac(bank, r)
    return DestructionReport(
        "fracdram", chip.stats.n_ops - start_ops,
        chip.stats.latency_ns - start_lat, chip.stats.energy_j - start_e,
        g.rows_per_bank)
