"""Fig 16 through the PyTorch port: spatial distribution of MAJ3 success
across a bank's subarrays (M-shaped systematic-variation profile; PULSAR
beats FracDRAM in every subarray — paper: +66.23% average).

The counterpart of ``benchmarks/fig16_spatial_success.py``. The port's
checked-in success table holds no per-subarray rates, so every point is
``MonteCarloDb``'s on ``device`` at the reference's sizes."""

from __future__ import annotations

import numpy as np

from benchmarks.common import Row, row, timed_us
from repro_torch.core.charact import MonteCarloDb


def run(device="cuda", seed: int = 0, db=None) -> list[Row]:
    if db is None:
        db = MonteCarloDb(n_bitlines=512, n_groups=4,
                          n_patterns=24, seed=seed, device=device)
    us, table = timed_us(lambda: db.fig16_spatial("H", n_subarrays=8),
                         repeat=1)
    pulsar = np.array([t[1] for t in table])
    frac = np.array([t[2] for t in table])
    gain = (pulsar.mean() / max(frac.mean(), 1e-9) - 1) * 100
    better_everywhere = bool((pulsar >= frac).all())
    # M-shape (visible on the unsaturated FracDRAM curve): success dips at
    # the quarter positions relative to the edges.
    m_shape = bool(frac[2] < frac[0] and frac[5] < frac[7])
    return [row("fig16.spatial", us,
                f"pulsar_mean={pulsar.mean():.3f} frac_mean={frac.mean():.3f} "
                f"gain={gain:.0f}% (paper +66.23%) "
                f"everywhere_better={better_everywhere} m_shape={m_shape}")]
