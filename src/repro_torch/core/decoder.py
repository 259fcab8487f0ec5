"""Hierarchical row-decoder model (paper §4.2, Figs 7-9).

The port's copy of ``repro.core.decoder``: host metadata, kept in NumPy.
The yield mask is drawn from ``np.random.default_rng(seed)``, so it is the
reference's for every seed.

A subarray's local row address (e.g. 9 bits for 512 rows) is split across
predecoders A..E with widths ``geometry.predecoder_widths`` (LSB-first).
Each predecoder one-hot-decodes its group and *latches* the asserted output.

An ``ACT R_F -> PRE -> ACT R_S`` (APA) sequence with violated tRP prevents the
PRE from resetting the latches, so after the second ACT every predecoder
holds the outputs for *both* addresses. Stage-2 of the local wordline decoder
asserts the full cross-product: with ``k`` groups in which R_F and R_S differ,
``2**k`` wordlines rise simultaneously.

Manufacturer behavior (profiles):
  * only the lowest ``double_latch_groups`` predecoders keep both latches;
    higher groups are reset by the PRE and take R_S's value only
    (models Mfr. M's 16-row cap and Samsung's non-functionality);
  * a per-chip Bernoulli yield mask marks which (subarray, group) paths
    double-latch at all — reproducing Table 1's N_RG% distributions.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np

from repro_torch.core.geometry import DramGeometry
from repro_torch.core.profiles import MfrProfile


def split_groups(addr: int, widths: tuple[int, ...]) -> tuple[int, ...]:
    """Split a local row address into predecoder group values (LSB-first)."""
    out = []
    for w in widths:
        out.append(addr & ((1 << w) - 1))
        addr >>= w
    return tuple(out)


def join_groups(groups: tuple[int, ...], widths: tuple[int, ...]) -> int:
    addr, shift = 0, 0
    for g, w in zip(groups, widths):
        addr |= g << shift
        shift += w
    return addr


@dataclasses.dataclass(frozen=True)
class RowDecoder:
    """Decoder for one bank; pure functions of (R_F, R_S)."""

    geometry: DramGeometry
    profile: MfrProfile
    # (subarrays, n_groups) bool: does this predecoder path double-latch?
    yield_mask: np.ndarray | None = None

    @staticmethod
    def build(geometry: DramGeometry, profile: MfrProfile,
              seed: int) -> "RowDecoder":
        rng = np.random.default_rng(seed)
        n_groups = len(geometry.predecoder_widths)
        mask = rng.random((geometry.subarrays_per_bank, n_groups)) < profile.pair_yield
        return RowDecoder(geometry, profile, mask)

    # ------------------------------------------------------------------ #

    def activated_rows(self, rf: int, rs: int) -> tuple[int, ...]:
        """Row addresses asserted by APA(rf, rs). Sorted, unique.

        rf/rs are bank-level row addresses; both must sit in the same
        subarray (the GWLD decodes the subarray index — different subarrays
        simply activate rs alone, as the GWL switches).
        """
        g = self.geometry
        sa_f, sa_s = g.subarray_of(rf), g.subarray_of(rs)
        if sa_f != sa_s:
            return (rs,)
        widths = g.predecoder_widths
        gf = split_groups(g.local_row(rf), widths)
        gs = split_groups(g.local_row(rs), widths)
        choices: list[tuple[int, ...]] = []
        for i, (a, b) in enumerate(zip(gf, gs)):
            latches_both = (
                a != b
                and i < self.profile.double_latch_groups
                and (self.yield_mask is None or bool(self.yield_mask[sa_s, i]))
            )
            choices.append((a, b) if latches_both else (b,))
        base = sa_s * g.rows_per_subarray
        rows = sorted(
            base + join_groups(combo, widths)
            for combo in itertools.product(*choices)
        )
        return tuple(rows)

    def n_activated(self, rf: int, rs: int) -> int:
        return len(self.activated_rows(rf, rs))

    # ------------------------------------------------------------------ #

    def find_group_pair(self, subarray: int, n_rows: int,
                        rng: np.random.Generator | None = None,
                        include: tuple[int, ...] = ()) -> tuple[int, int]:
        """Find (rf, rs) in ``subarray`` activating exactly ``n_rows`` rows.

        ``include``: bank-level rows that must be inside the activated set
        (used by the ALU row allocator to target staged operand rows).
        Raises ValueError when the chip cannot activate ``n_rows`` rows.
        """
        if n_rows & (n_rows - 1):
            raise ValueError("n_rows must be a power of two")
        k = n_rows.bit_length() - 1
        g = self.geometry
        usable = [
            i for i in range(len(g.predecoder_widths))
            if i < self.profile.double_latch_groups
            and (self.yield_mask is None or bool(self.yield_mask[subarray, i]))
        ]
        if len(usable) < k:
            raise ValueError(
                f"chip (Mfr {self.profile.name}) cannot activate {n_rows} rows "
                f"in subarray {subarray}: only {len(usable)} double-latching "
                f"predecoder groups")
        rng = rng or np.random.default_rng(0)
        widths = g.predecoder_widths
        base = subarray * g.rows_per_subarray
        if include:
            loc = g.local_row(include[0])
            gf = list(split_groups(loc, widths))
        else:
            gf = [int(rng.integers(0, 1 << w)) for w in widths]
        gs = list(gf)
        for i in usable[:k]:
            gs[i] = gf[i] ^ ((1 << widths[i]) - 1 if widths[i] == 1 else 1 + int(rng.integers(0, (1 << widths[i]) - 1)))
            gs[i] &= (1 << widths[i]) - 1
            if gs[i] == gf[i]:  # ensure difference
                gs[i] = (gf[i] + 1) & ((1 << widths[i]) - 1)
        rf = base + join_groups(tuple(gf), widths)
        rs = base + join_groups(tuple(gs), widths)
        assert self.n_activated(rf, rs) == n_rows, (rf, rs)
        return rf, rs

    def nrg_census(self, subarray: int = 0,
                   sample: int | None = None,
                   seed: int = 0) -> dict[int, float]:
        """Fraction of ordered (rf != rs) same-subarray pairs activating each
        row count — Table 1's N_RG% columns.

        ``sample``: if set, Monte-Carlo over that many pairs (the full census
        is exact/brute force over n*(n-1) pairs otherwise).
        """
        g = self.geometry
        n = g.rows_per_subarray
        base = subarray * g.rows_per_subarray
        rng = np.random.default_rng(seed)
        counts: dict[int, int] = {}
        if sample is None:
            pairs = ((a, b) for a in range(n) for b in range(n) if a != b)
            total = n * (n - 1)
        else:
            def _gen():
                for _ in range(sample):
                    a = int(rng.integers(0, n))
                    b = int(rng.integers(0, n - 1))
                    if b >= a:
                        b += 1
                    yield a, b
            pairs = _gen()
            total = sample
        for a, b in pairs:
            c = self.n_activated(base + a, base + b)
            counts[c] = counts.get(c, 0) + 1
        return {k: v / total for k, v in sorted(counts.items())}
