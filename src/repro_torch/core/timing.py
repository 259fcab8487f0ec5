"""DDR4 timing parameters and violated-timing constants (paper §2.2, §5.2).

All values in nanoseconds, DDR4-2400 grade (DRAM Bender's stock part), JEDEC
JESD79-4C. The PuM command sequences *violate* tRAS / tRP with the sub-3ns
gaps the paper reports; nominal parameters still govern everything else, and
tFAW / tRRD limit the activation rate (Appendix A: power constraints).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DramTimings:
    tck: float = 0.833       # DDR4-2400: 1200 MHz clock
    trcd: float = 13.32      # ACT -> RD/WR
    trp: float = 13.32       # PRE -> ACT
    tras: float = 32.0       # ACT -> PRE (restore)
    trc: float = 45.32       # ACT -> ACT (same bank)
    trrd_s: float = 3.332    # ACT -> ACT different bank group
    trrd_l: float = 4.998    # ACT -> ACT same bank group
    tfaw: float = 30.0       # rolling four-activation window
    twr: float = 15.0        # write recovery
    trtp: float = 7.5        # read -> PRE
    tccd_s: float = 3.332    # burst-to-burst, diff bank group
    tccd_l: float = 5.0      # burst-to-burst, same bank group
    tbl: float = 3.332       # BL8 burst duration
    trfc: float = 350.0      # refresh (4 Gb)
    trefi: float = 7800.0    # refresh interval
    # --- violated timings used by PuM sequences (paper: "< 3 ns") ---
    t_apa_gap: float = 2.5   # ACT->PRE and PRE->ACT gap in the APA sequence
    t_frac: float = 9.0      # FracDRAM's truncated restore before PRE
    # Energy per command, nJ-scale (Rambus/Vogelsang-style constants; used
    # only for relative energy reporting).
    e_act: float = 0.909e-9
    e_pre: float = 0.578e-9
    e_rdwr_burst: float = 1.51e-9
    e_ref: float = 26.3e-9   # one all-bank REF cycle (tRFC at IDD5)

    @property
    def t_aap(self) -> float:
        """ACT (full restore) -> PRE -> ACT sequence with violated tRP.

        This is RowClone / Multi-RowInit's trigger: first row fully sensed
        (tRAS honored), PRE interrupted by the second ACT after t_apa_gap,
        then the destination rows are overdriven by the latched sense amps
        for a full restore window, and the bank is finally precharged.
        """
        return self.tras + self.t_apa_gap + self.tras + self.trp

    @property
    def t_apa(self) -> float:
        """ACT -> PRE -> ACT with *both* gaps violated (charge sharing,
        §5.2.2): neither the first row's restore nor the precharge completes;
        after the second ACT all rows share charge, then sense + restore +
        precharge."""
        return self.t_apa_gap + self.t_apa_gap + self.tras + self.trp

    @property
    def t_wr_row(self) -> float:
        """One WR burst into an open row + write recovery + precharge."""
        return self.trcd + self.tbl + self.twr + self.trp

    @property
    def t_frac_op(self) -> float:
        """FracDRAM Frac: ACT truncated at t_frac, then PRE (row left ~VDD/2)."""
        return self.t_frac + self.trp


DDR4_2400 = DramTimings()
