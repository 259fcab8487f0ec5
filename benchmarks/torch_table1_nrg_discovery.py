"""Table 1: N_RG% — fraction of same-subarray (R_F, R_S) pairs that
simultaneously activate 2/4/8/16/32 rows, per manufacturer profile.

The PyTorch port's counterpart of
``benchmarks/table1_nrg_discovery.py``: the same rows and ``derived``
strings from the port's row decoder on the host; ``run`` takes
``device`` only so that every figure module is called alike.
"""

from __future__ import annotations

from benchmarks.common import Row, row, timed_us
from repro_torch.core.decoder import RowDecoder
from repro_torch.core.geometry import DramGeometry
from repro_torch.core.profiles import MFR_H, MFR_M, MFR_S

G9 = DramGeometry(row_bits=1024, rows_per_subarray=512, subarrays_per_bank=4,
                  banks=1)

PAPER = {  # H7-11 row of Table 1
    "H": {2: 0.0249, 4: 0.1263, 8: 0.3077, 16: 0.3533, 32: 0.0183},
    "M": {2: 0.0191, 4: 0.1292, 8: 0.3287, 16: 0.2083, 32: 0.0},
}


def run(device="cuda") -> list[Row]:
    rows: list[Row] = []
    for prof in (MFR_H, MFR_M, MFR_S):
        dec = RowDecoder.build(G9, prof, seed=11)

        def census():
            return dec.nrg_census(0, sample=4000, seed=3)

        us, c = timed_us(census, repeat=1)
        got = " ".join(f"{k}:{100*v:.1f}%" for k, v in c.items() if k > 1)
        paper = PAPER.get(prof.name)
        ref = (" paper " + " ".join(f"{k}:{100*v:.1f}%"
                                    for k, v in paper.items())
               if paper else " (no multi-row activation, as observed)")
        rows.append(row(f"table1.nrg_census_mfr{prof.name}", us,
                        f"sim {got or 'none'}{ref}"))
    return rows
