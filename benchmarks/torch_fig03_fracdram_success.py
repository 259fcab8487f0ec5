"""Fig 3 through the PyTorch port: FracDRAM (state-of-the-art baseline)
MAJ3 success-rate distribution across DDR4 modules — the paper's
motivating measurement (mean 78.85% on Mfr H DDR4; 19.37% below its DDR3
result).

The counterpart of ``benchmarks/fig03_fracdram_success.py``: the same row
and ``derived`` format, its Monte-Carlo points from
``repro_torch.core.charact.MonteCarloDb`` on ``device`` (the
charge-sharing kernel on a CUDA card) at the reference's sizes."""

from __future__ import annotations

import numpy as np

from benchmarks.common import Row, row, timed_us
from repro_torch.core.charact import MonteCarloDb

PAPER_MEAN = 0.7885


def run(device="cuda", seed: int = 0, db=None) -> list[Row]:
    """``db``: any object with ``point(mfr, m, n, subarray_frac=)``
    (default ``MonteCarloDb(seed=seed)`` on ``device``)."""
    if db is None:
        db = MonteCarloDb(n_bitlines=1024, n_groups=6,
                          n_patterns=32, seed=seed, device=device)

    def sweep():
        # 12 modules ~ 12 subarray positions across the bank (systematic PV).
        return [db.point("H", 3, 4, subarray_frac=(i + 0.5) / 12).mean
                for i in range(12)]

    us, rates = timed_us(sweep, repeat=1)
    mean = float(np.mean(rates))
    return [row("fig03.fracdram_maj3_ddr4_mean", us,
                f"sim={mean:.4f} paper={PAPER_MEAN} "
                f"min={min(rates):.3f} max={max(rates):.3f}")]
