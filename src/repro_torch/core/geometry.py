"""DRAM geometry description.

Models the organization of a DDR4 module at the granularity the paper uses:
channel -> rank -> chip -> bank -> subarray -> row -> bitline (§2.1).

The *logical dataplane* treats one DRAM row as ``row_bits`` bitlines packed
into ``uint32`` words (bit ``b`` of word ``w`` is bitline ``32*w + b``).
The paper operates on module-level rows (all chips in a rank in lockstep):
65 536 bitlines per module row for an x8 rank (Table 1); tests use smaller
geometries for speed — everything is parameterized.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DramGeometry:
    """Geometry of one DRAM bank (module-level lockstep view)."""

    row_bits: int = 65536          # bitlines per (module-level) row
    rows_per_subarray: int = 512   # paper: 512-1024 (Table 1, "SA Size")
    subarrays_per_bank: int = 4    # reverse-engineered: up to 2^7; small default
    banks: int = 16                # DDR4: 16 banks (4 bank groups x 4)
    # Row-address split inside a subarray: predecoder group widths, LSB first.
    # Paper §4.2: predecoders A..E latch 18 bits total = 4+4+4+4+2 outputs
    # from address-bit groups of widths (2,2,2,2,1) over the 9-bit local row
    # address of a 512-row subarray.
    predecoder_widths: tuple[int, ...] = (2, 2, 2, 2, 1)

    def __post_init__(self) -> None:
        if self.row_bits % 32 != 0:
            raise ValueError("row_bits must be a multiple of 32")
        if sum(self.predecoder_widths) != self.local_addr_bits:
            raise ValueError(
                f"predecoder widths {self.predecoder_widths} must cover "
                f"{self.local_addr_bits} local address bits "
                f"(rows_per_subarray={self.rows_per_subarray})"
            )

    @property
    def words_per_row(self) -> int:
        return self.row_bits // 32

    @property
    def rows_per_bank(self) -> int:
        return self.rows_per_subarray * self.subarrays_per_bank

    @property
    def local_addr_bits(self) -> int:
        n = self.rows_per_subarray
        if n & (n - 1):
            raise ValueError("rows_per_subarray must be a power of two")
        return n.bit_length() - 1

    @property
    def row_bytes(self) -> int:
        return self.row_bits // 8

    def subarray_of(self, row: int) -> int:
        return row // self.rows_per_subarray

    def local_row(self, row: int) -> int:
        return row % self.rows_per_subarray


# Geometries used throughout the repo ---------------------------------------

# Module-level geometry matching the paper's evaluation rows (65 536 bitlines,
# 512-row subarrays, Mfr-H-like H0-6 modules).
PAPER_MODULE = DramGeometry(row_bits=65536, rows_per_subarray=512,
                            subarrays_per_bank=16, banks=16)

# Small geometry for unit tests: fast, same code paths.
TEST_GEOMETRY = DramGeometry(row_bits=1024, rows_per_subarray=64,
                             subarrays_per_bank=2, banks=2,
                             predecoder_widths=(2, 2, 2))
