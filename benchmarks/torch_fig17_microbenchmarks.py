"""Fig 17: the seven arithmetic/logic microbenchmarks — PULSAR (per-op
best-throughput config search) vs FracDRAM (MAJ3@4) per manufacturer.

Per-op latencies are priced through the MemoryController's scheduled
bank batches (16 banks: tFAW/tRRD-limited effective parallelism plus the
steady-state refresh factor), not the closed-form bank divide.

Paper: 2.21x (Mfr M) / 1.46x (Mfr H) average speedup; our conservative
per-op staging model reproduces the structure (M > H, logic > arithmetic,
MAJ9 degradation) with smaller magnitudes — analysed in EXPERIMENTS.md.

Units: the CSV's ``us_per_call`` column is *host* wall time of the
pricing pass (as in every benchmark module); the model-domain DRAM
latencies live in ``derived`` with explicit ``ns`` suffixes
(``pulsar=..ns frac=..ns``, success-rate-adjusted amortized per-row
latency from ``op_effective_ns``) alongside the dimensionless speedups.

The PyTorch port's counterpart of ``benchmarks/fig17_microbenchmarks.py``:
the same rows and ``derived`` strings, priced by the port's engines on
``device`` (the pricing itself is host work: the controller's scheduled
batches and the checked-in success table).
"""

from __future__ import annotations

import numpy as np

from benchmarks.common import Row, row, timed_us
from repro_torch.core.engine import PulsarEngine

KINDS = {
    "and": ("reduce_and", 64),
    "or": ("reduce_or", 64),
    "xor": ("reduce_xor", 64),
    "add": ("add", None),
    "sub": ("sub", None),
    "mul": ("mul", None),
    "div": ("div", None),
}

PAPER_AVG = {"M": 2.21, "H": 1.46}


def run(device="cuda") -> list[Row]:
    rows: list[Row] = []
    for mfr in ("M", "H"):
        pulsar = PulsarEngine(mfr=mfr, width=32, use_pulsar=True,
                              controller="auto", device=device)
        chained = PulsarEngine(mfr=mfr, width=32, use_pulsar=True,
                               chained=True, controller="auto",
                               device=device)
        frac = PulsarEngine(mfr=mfr, width=32, use_pulsar=False,
                            controller="auto", device=device)
        speeds = {}

        def bench():
            for name, (kind, planes) in KINDS.items():
                l_p, sr_p, m, n = pulsar.op_effective_ns(kind, 32, planes)
                l_c, sr_c, _, _ = chained.op_effective_ns(kind, 32, planes)
                l_f, sr_f, _, _ = frac.op_effective_ns(kind, 32, planes)
                eff_f = l_f / sr_f
                eff_p = l_p / sr_p
                speeds[name] = (eff_f / eff_p, eff_f / (l_c / sr_c),
                                m, n, eff_p, eff_f)
            return speeds

        us, sp = timed_us(bench, repeat=1)
        for name, (s, sc, m, n, eff_p, eff_f) in sp.items():
            # Dimensionless speedups + the model-domain latencies behind
            # them, each with its unit spelled out (the us_per_call
            # column is host wall time of the pricing pass, NOT ns).
            rows.append(row(f"fig17.{name}_{mfr}", us / 7,
                            f"speedup={s:.2f}x chained={sc:.2f}x "
                            f"pulsar={eff_p:.1f}ns frac={eff_f:.1f}ns "
                            f"cfg=MAJ{m}@N{n}"))
        avg = float(np.mean([s for s, *_ in sp.values()]))
        avg_c = float(np.mean([sc for _, sc, *_ in sp.values()]))
        # Controller-derived bank scaling of the PULSAR add config: how much
        # of the 16-bank ideal survives tFAW/tRRD + refresh.
        b = pulsar._batch_for("add", *pulsar._cfg_for("add", 32, None)[:2])
        rows.append(row(
            f"fig17.avg_{mfr}", us,
            f"sim={avg:.2f}x chained={avg_c:.2f}x paper={PAPER_AVG[mfr]}x "
            f"bank_p_eff={b.parallel_speedup:.2f}/16 "
            f"refresh_factor={b.refresh_factor:.4f}"))
    return rows
