"""Fig 19: cold-boot content destruction of one bank — PULSAR (Bulk-Write +
greedy Multi-RowInit cover, N=2..32) vs RowClone- and FracDRAM-based
baselines (paper: up to 20.87x / 7.55x; normalized to RowClone).

The PyTorch port's counterpart of ``benchmarks/fig19_destruction.py``:
the same rows and ``derived`` strings from the port's cost model on the
host; ``run`` takes ``device`` only so that every figure module is
called alike.
"""

from __future__ import annotations

from benchmarks.common import Row, row, timed_us
from repro_torch.core.cost_model import CostModel
from repro_torch.core.destruction import (fracdram_destruction_cost,
                                    pulsar_destruction_cost,
                                    rowclone_destruction_cost)

ROWS_SA, N_SA = 512, 16  # paper-scale bank (H7 module)


def run(device="cuda") -> list[Row]:
    cm = CostModel(row_bits=65536)
    n_rows = ROWS_SA * N_SA

    def sweep():
        rc = rowclone_destruction_cost(cm, n_rows).latency_ns
        fr = fracdram_destruction_cost(cm, n_rows).latency_ns
        pul = {n: pulsar_destruction_cost(cm, ROWS_SA, N_SA, n).latency_ns
               for n in (2, 4, 8, 16, 32)}
        return rc, fr, pul

    us, (rc, fr, pul) = timed_us(sweep, repeat=1)
    rows = [row("fig19.rowclone_base", us / 7,
                f"{rc/1e6:.2f} ms/bank (1.00x)"),
            row("fig19.fracdram", us / 7,
                f"{fr/1e6:.2f} ms/bank ({rc/fr:.2f}x vs RowClone)")]
    for n, lat in pul.items():
        note = " paper:20.87x-vs-RC 7.55x-vs-Frac" if n == 32 else ""
        rows.append(row(f"fig19.pulsar_n{n}", us / 7,
                        f"{lat/1e6:.2f} ms/bank ({rc/lat:.2f}x vs RowClone, "
                        f"{fr/lat:.2f}x vs Frac){note}"))
    return rows
