"""Fig 14 through the PyTorch port: MAJ3 success rate vs N_RG per
manufacturer (PULSAR headline: 97.91% at N=32 vs FracDRAM 78.85% —
+24.18 points).

The counterpart of ``benchmarks/fig14_maj3_success.py``, its points from
``MonteCarloDb`` on ``device`` at the reference's sizes."""

from __future__ import annotations

from benchmarks.common import Row, row, timed_us
from repro_torch.core.charact import MonteCarloDb

PAPER = {("H", 4): 0.7885, ("H", 32): 0.9791}


def run(device="cuda", seed: int = 0, db=None) -> list[Row]:
    if db is None:
        db = MonteCarloDb(n_bitlines=1024, n_groups=6,
                          n_patterns=32, seed=seed, device=device)
    rows: list[Row] = []
    for mfr, ns in (("H", (4, 8, 16, 32)), ("M", (4, 8, 16))):
        for n in ns:
            us, pt = timed_us(lambda m=mfr, nn=n: db.point(m, 3, nn),
                              repeat=1)
            ref = PAPER.get((mfr, n))
            rows.append(row(
                f"fig14.maj3_{mfr}_n{n}", us,
                f"sim={pt.mean:.4f} iqr=[{pt.q1:.3f},{pt.q3:.3f}]"
                + (f" paper={ref}" if ref else "")))
    h4 = db.mean("H", 3, 4)
    h32 = db.mean("H", 3, 32)
    rows.append(row("fig14.pulsar_vs_fracdram_gain", 0.0,
                    f"sim=+{100*(h32-h4):.1f}pts paper=+24.18pts"))
    return rows
