"""Fig 15 through the PyTorch port: MAJ3/5/7/9 success rates vs N_RG
(first demonstration of reliable >3-input majority: paper MAJ5 73.93%,
MAJ7 29.28% on Mfr H @32; MAJ9+ omitted on M per its <1% observation).

The counterpart of ``benchmarks/fig15_majm_success.py``, its points from
``MonteCarloDb`` on ``device`` at the reference's sizes."""

from __future__ import annotations

from benchmarks.common import Row, row, timed_us
from repro_torch.core.charact import MonteCarloDb
from repro_torch.core.profiles import PROFILES

PAPER = {("H", 5, 32): 0.7393, ("H", 7, 32): 0.2928}


def run(device="cuda", seed: int = 0, db=None) -> list[Row]:
    if db is None:
        db = MonteCarloDb(n_bitlines=1024, n_groups=6,
                          n_patterns=32, seed=seed, device=device)
    rows: list[Row] = []
    for mfr in ("H", "M"):
        prof = PROFILES[mfr]
        for m in (3, 5, 7, 9):
            if m > prof.max_maj_fan_in:
                rows.append(row(f"fig15.maj{m}_{mfr}", 0.0,
                                "omitted (<1% success, as in paper)"))
                continue
            n = 4
            pts = {}
            while n <= prof.max_simul_rows:
                if n >= m:
                    us, pt = timed_us(
                        lambda mm=m, nn=n, f=mfr: db.point(f, mm, nn),
                        repeat=1)
                    pts[n] = pt.mean
                n <<= 1
            ref = {k[2]: v for k, v in PAPER.items()
                   if k[0] == mfr and k[1] == m}
            rows.append(row(
                f"fig15.maj{m}_{mfr}", us,
                "sim " + " ".join(f"N{k}:{v:.3f}" for k, v in pts.items())
                + (" paper " + " ".join(f"N{k}:{v}" for k, v in ref.items())
                   if ref else "")))
    return rows
