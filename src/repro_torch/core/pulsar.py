"""PULSAR executor: MAJ-M with input replication on the chip model (§5).

The port's copy of ``repro.core.pulsar``. The executor schedules the same
command programs as the reference on a :class:`~repro_torch.core.chip.
PulsarChip` whose bank payload lies on a torch device; every APA it issues
is one vote of the MAJ-N kernel on a CUDA chip. :func:`buddy_assign` is
also what the cost model prices MAJ staging from.

Staging strategy (the paper's limitation #1 is that chips do not let you pick
arbitrary activation sets, so addresses must be co-designed with the decoder):

* An ``NrgRegion`` is the decoder-determined set of ``N = 2^k`` rows activated
  by APA(rf, rs); each row corresponds to a *combo index* in {0,1}^k choosing,
  per differing predecoder group, either rf's or rs's value.
* The replication plan (c copies per input + neutrals) is packed into the
  combo hypercube with a buddy allocator: every power-of-two block of combo
  indices is itself a decoder-realizable activation set, so a block of
  2^j copies is initialized with ONE Multi-RowInit (plus one RowClone
  copy-in) — this is exactly why Multi-RowInit makes replication cheap
  (Fig 18: init latency is the limiting factor at large N).
* Neutral rows are Frac ops (Mfr. H) or bias-pattern writes (Mfr. M,
  footnote 4).

Per-op cost (AAP = one violated-timing ACT->PRE->ACT):
    copy-ins   = (#binary blocks of c) RowClones          per input
    fills      = (#blocks with size > 1) Multi-RowInits   per input
    neutrals   = n_neutral Frac ops
    compute    = 1 APA (charge share)
    copy-out   = 1 RowClone
The FracDRAM baseline (MAJ3 @ N=4, no replication) degenerates to
3 copy-ins + 1 Frac + APA + copy-out, matching prior work's sequences.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

import numpy as np
import torch

from repro_torch.core.decoder import join_groups, split_groups
from repro_torch.core.replication import plan as replication_plan, plan_pow2

if TYPE_CHECKING:  # the chip imports the engine, which imports this module
    from repro_torch.core.chip import PulsarChip


@dataclasses.dataclass(frozen=True)
class NrgRegion:
    """An APA-activatable region of 2^k rows in one subarray."""
    bank: int
    rf: int
    rs: int
    # groups (indices into predecoder groups) that differ between rf/rs,
    # in LSB-first combo-bit order.
    varying_groups: tuple[int, ...]
    rows_by_combo: tuple[int, ...]  # combo index -> bank-level row address

    @property
    def k(self) -> int:
        return len(self.varying_groups)

    @property
    def n_rows(self) -> int:
        return 1 << self.k

    def block_anchor_pair(self, start: int, size: int) -> tuple[int, int]:
        """(rf', rs') whose APA set is exactly the combo block
        [start, start+size); block must be buddy-aligned."""
        if size & (size - 1) or start % size:
            raise ValueError("block must be power-of-two sized and aligned")
        j = size.bit_length() - 1
        a = self.rows_by_combo[start]
        b = self.rows_by_combo[start + size - 1]  # flips exactly j low bits
        return a, b


def build_region(chip: "PulsarChip", bank: int, subarray: int,
                 n_rg: int, seed: int = 0) -> NrgRegion:
    g = chip.geometry
    rng = np.random.default_rng(seed)
    rf, rs = chip.decoder.find_group_pair(subarray, n_rg, rng)
    widths = g.predecoder_widths
    gf = split_groups(g.local_row(rf), widths)
    gs = split_groups(g.local_row(rs), widths)
    varying = tuple(i for i in range(len(widths)) if gf[i] != gs[i])
    base = subarray * g.rows_per_subarray
    rows = []
    for combo in range(1 << len(varying)):
        vals = list(gf)
        for bit, gi in enumerate(varying):
            if (combo >> bit) & 1:
                vals[gi] = gs[gi]
        rows.append(base + join_groups(tuple(vals), widths))
    region = NrgRegion(bank=bank, rf=rf, rs=rs, varying_groups=varying,
                       rows_by_combo=tuple(rows))
    assert set(region.rows_by_combo) == set(chip.decoder.activated_rows(rf, rs))
    return region


def buddy_assign(m_inputs: int, copies: int, n_neutral: int, k: int
                 ) -> tuple[list[list[tuple[int, int]]], list[tuple[int, int]]]:
    """Pack m_inputs * copies + n_neutral slots into the 2^k combo hypercube.

    Returns (per-input block lists, neutral blocks); blocks are (start, size),
    buddy-aligned. Total demand always equals 2^k (replication plan invariant),
    so the packing is exact.
    """
    demands: list[tuple[int, int]] = []   # (owner, size); owner -1 = neutral
    for owner, count in [(i, copies) for i in range(m_inputs)] + [(-1, n_neutral)]:
        c = count
        bit = 1
        while c:
            if c & 1:
                demands.append((owner, bit))
            c >>= 1
            bit <<= 1
    demands.sort(key=lambda d: -d[1])
    free: dict[int, list[int]] = {1 << k: [0]}  # size -> [starts]
    per_input: list[list[tuple[int, int]]] = [[] for _ in range(m_inputs)]
    neutral_blocks: list[tuple[int, int]] = []
    for owner, size in demands:
        s = size
        while s <= (1 << k) and not free.get(s):
            s <<= 1
        if s > (1 << k):
            raise RuntimeError("buddy packing failed (invariant violated)")
        start = free[s].pop(0)
        while s > size:  # split down
            s >>= 1
            free.setdefault(s, []).append(start + s)
        block = (start, size)
        if owner < 0:
            neutral_blocks.append(block)
        else:
            per_input[owner].append(block)
    return per_input, neutral_blocks


@dataclasses.dataclass
class MajOpReport:
    n_rg: int
    m_inputs: int
    copies: int
    n_neutral: int
    n_copy_in: int
    n_fill: int
    n_frac: int
    n_apa: int = 1
    n_copy_out: int = 1

    @property
    def total_aaps(self) -> int:
        """All violated-timing row-pair sequences (copy-ins, fills, APA,
        copy-out) — the unit prior work counts."""
        return self.n_copy_in + self.n_fill + self.n_apa + self.n_copy_out


class PulsarExecutor:
    """Executes MAJ / init / write primitives with PULSAR's staging."""

    def __init__(self, chip: "PulsarChip", bank: int = 0, subarray: int = 0,
                 seed: int = 0):
        self.chip = chip
        self.bank = bank
        self.subarray = subarray
        self.seed = seed
        self._regions: dict[int, NrgRegion] = {}

    def region(self, n_rg: int) -> NrgRegion:
        if n_rg not in self._regions:
            self._regions[n_rg] = build_region(
                self.chip, self.bank, self.subarray, n_rg, self.seed)
        return self._regions[n_rg]

    def max_n_rg(self) -> int:
        p, g = self.chip.profile, self.chip.geometry
        usable = min(p.double_latch_groups, len(g.predecoder_widths))
        if self.chip.decoder.yield_mask is not None:
            usable = min(usable, int(self.chip.decoder.yield_mask[self.subarray].sum()))
        return min(1 << usable, p.max_simul_rows)

    # ------------------------------------------------------------------ #

    def maj(self, dst_row: int, src_rows: list[int], n_rg: int,
            stability_mask=None,
            plan_style: str = "pow2",
            in_place_input: int | None = None) -> MajOpReport:
        """dst = MAJ_M(srcs) via an N_RG-row simultaneous activation with
        input replication. ``src_rows`` may repeat a row (weighted inputs,
        e.g. the MAJ5 full-adder's double ¬Cout).

        plan_style: "pow2" (staging-efficient, default for compute) or
        "max" (paper's maximal replication, used for characterization).

        ``in_place_input``: CHAINED-STAGING optimization (beyond paper):
        after any APA, the charge-shared result is restored to ALL activated
        rows — so when this op's input i is the immediately preceding op's
        output in the SAME region, its copies are already resident in every
        slot (including its own block) and its staging is skipped entirely.
        The caller (the ALU) guarantees residency; the chip model verifies
        it bit-exactly.
        """
        m = len(src_rows)
        rp = (plan_pow2 if plan_style == "pow2" else replication_plan)(m, n_rg)
        region = self.region(n_rg)
        if region.n_rows != n_rg:
            raise RuntimeError("region size mismatch")
        per_input, neutral_blocks = buddy_assign(m, rp.copies, rp.n_neutral,
                                                 region.k)
        chip = self.chip
        n_copy_in = n_fill = n_frac = 0
        for i, blocks in enumerate(per_input):
            if i == in_place_input:
                # Verify residency (model invariant, zero DRAM commands;
                # one device sync per row on a CUDA chip).
                for start, size in blocks:
                    for s in range(start, start + size):
                        r = region.rows_by_combo[s]
                        if not torch.equal(chip.peek(self.bank, r),
                                           chip.peek(self.bank,
                                                     src_rows[i])):
                            raise RuntimeError(
                                "in_place_input not resident in region")
                continue
            for start, size in blocks:
                first = region.rows_by_combo[start]
                chip.row_clone(self.bank, src_rows[i], first)
                n_copy_in += 1
                if size > 1:
                    a, b = region.block_anchor_pair(start, size)
                    assert a == first  # copy-in landed on the block anchor
                    got = chip.multi_row_init(self.bank, a, b)
                    assert set(got) == {region.rows_by_combo[s]
                                        for s in range(start, start + size)}
                    n_fill += 1
        for start, size in neutral_blocks:
            if chip.profile.frac_supported:
                for s in range(start, start + size):
                    chip.frac(self.bank, region.rows_by_combo[s])
                    n_frac += 1
            else:
                a, b = region.block_anchor_pair(start, size)
                chip.frac_block(self.bank, a, b)
                n_frac += 1 + (1 if size > 1 else 0)
        chip.apa_maj(self.bank, region.rf, region.rs,
                     stability_mask=stability_mask)
        chip.row_clone(self.bank, region.rows_by_combo[0], dst_row)
        return MajOpReport(n_rg=n_rg, m_inputs=m, copies=rp.copies,
                           n_neutral=rp.n_neutral, n_copy_in=n_copy_in,
                           n_fill=n_fill, n_frac=n_frac)

    def fracdram_maj3(self, dst_row: int, src_rows: list[int],
                      stability_mask=None) -> MajOpReport:
        """State-of-the-art baseline [26]: MAJ3 on a 4-row activation, one
        copy per input + one Frac row, no replication."""
        return self.maj(dst_row, src_rows, n_rg=4,
                        stability_mask=stability_mask)

    def multi_row_init_block(self, src_row: int, n_rows: int) -> tuple[int, ...]:
        """Copy src into a 2^j block (Multi-RowInit primitive, §5.2.1)."""
        region = self.region(n_rows)
        first = region.rows_by_combo[0]
        self.chip.row_clone(self.bank, src_row, first)
        return self.chip.multi_row_init(self.bank, region.rf, region.rs)

    def bulk_write_block(self, data, n_rows: int) -> tuple[int, ...]:
        region = self.region(n_rows)
        return self.chip.bulk_write(self.bank, region.rf, region.rs, data)
