"""Manufacturer / module profiles for the DRAM device model.

The paper characterizes 120 DDR4 chips from two manufacturers (Table 1):

* Mfr. H (SK Hynix): up to 32 simultaneous rows, Frac supported,
  lower success rates (weaker sense amps — paper's hypothesis, §6.1.1).
* Mfr. M (Micron): up to 16 simultaneous rows, Frac NOT supported but sense
  amps biased by cell polarity (footnote 4), higher success rates.
* Samsung: no multi-row activation at all (§7 Limitations) — internal
  circuitry ignores the violated PRE / second ACT.

Analog-model calibration constants are chosen so the simulator lands on the
paper's anchor numbers (see ``tests/core/test_calibration.py`` and
EXPERIMENTS.md §Repro):
  - FracDRAM-style MAJ3 (N=4) on DDR4 ~ 78.85 % mean success,
  - PULSAR MAJ3 @ N=32 ~ 97.91 %, MAJ5 ~ 73.93 %, MAJ7 ~ 29.28 %,
  - bitline deviation of N=32 MAJ3 ~ +159 % vs N=4 (§5.1) — this one is
    *analytic*: ratio = copies * (C_bl + 4C) / (C_bl + 32C) with
    C_bl/C = 5.8 giving 10*(5.8+4)/(5.8+32) = 2.59.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MfrProfile:
    name: str
    # How many predecoder groups can double-latch (paper §4.2): the number of
    # simultaneously activated rows is 2**k, k <= double_latch_groups.
    double_latch_groups: int
    max_simul_rows: int
    frac_supported: bool
    # Sense amps biased to cell polarity (Mfr. M footnote 4): neutral rows are
    # emulated by writing the bias pattern instead of a Frac VDD/2 charge.
    sa_bias_neutral: bool
    # --- analog calibration ---
    cell_cap_ff: float = 20.0        # ITRS 22 nm-class cell capacitance
    bitline_cap_ratio: float = 5.8   # C_bl / C_cell (calibrated, see module doc)
    vdd: float = 1.2
    # Static per-bitline mismatch: sense-amp offset sigma (volts).
    sense_offset_sigma: float = 0.016
    # Per-cell capacitance sigma as a fraction of C_cell ("process variation").
    process_variation: float = 0.20
    # Trial (dynamic) noise sigma in volts; a bitline is "stable" only if its
    # static margin survives ~max |noise| over 10^4 trials (~3.7 sigma).
    trial_noise_sigma: float = 0.004
    # Data-pattern interference (§6.1.1: random patterns hurt; PARBOR-style
    # cell-to-cell coupling). Scales with sqrt(N_activated) (volts per sqrt-row).
    coupling_sigma: float = 0.0035
    # Fraction of (R_F, R_S) pairs whose decoder path supports double-latching
    # per group — chip-level manufacturing yield knob for Table 1 N_RG%.
    pair_yield: float = 0.80
    # Largest demonstrated-reliable MAJ fan-in (§6.1.1: H shows MAJ9 with low
    # success, "MAJ11+ for Mfr H and MAJ9+ for Mfr M" are <1% and omitted).
    max_maj_fan_in: int = 9

    @property
    def bitline_cap_ff(self) -> float:
        return self.cell_cap_ff * self.bitline_cap_ratio


# Calibration (see tests/core/test_analog_calibration.py and EXPERIMENTS.md):
# fitted numerically (grid search over the Monte-Carlo model) against the
# paper's anchors
#   H: MAJ3@4 ~ 0.79, MAJ3@32 ~ 0.98, MAJ5@32 ~ 0.74, MAJ7@32 ~ 0.29
# giving H: offset 33 mV, pv 5%, coupling 2.2 mV/sqrt-row -> simulated
# 0.77 / 0.999 / 0.80 / 0.23. The anchors force a large static sense-amp
# offset plus sqrt(N)-growing coupling noise — matching the paper's own
# hypotheses (weak Mfr-H sense amps; data-pattern cell interference).
# Mfr M: "more robust sense amplifiers" => much smaller offset/coupling.
MFR_H = MfrProfile(
    name="H",
    double_latch_groups=5,
    max_simul_rows=32,
    frac_supported=True,
    sa_bias_neutral=False,
    sense_offset_sigma=0.033,
    process_variation=0.05,
    coupling_sigma=0.0022,
    trial_noise_sigma=0.001,
    pair_yield=0.78,
    max_maj_fan_in=9,
)

MFR_M = MfrProfile(
    name="M",
    double_latch_groups=4,
    max_simul_rows=16,
    frac_supported=False,
    sa_bias_neutral=True,
    sense_offset_sigma=0.008,    # "more robust sense amplifiers" (§6.1.1)
    process_variation=0.08,
    coupling_sigma=0.0011,
    trial_noise_sigma=0.001,
    pair_yield=0.70,
    max_maj_fan_in=7,
)

MFR_S = MfrProfile(
    name="S",
    double_latch_groups=0,       # no multi-row activation (§7)
    max_simul_rows=1,
    frac_supported=False,
    sa_bias_neutral=False,
)

PROFILES: dict[str, MfrProfile] = {"H": MFR_H, "M": MFR_M, "S": MFR_S}
