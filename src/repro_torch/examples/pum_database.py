"""PuM-accelerated database analytics (paper Appendix B use case).

    PYTHONPATH=src python -m repro_torch.examples.pum_database

The port's counterpart of ``examples/pum_database.py``: the paper's two
database workloads on the PULSAR engine through the public
``repro_torch.pum`` API, fused flushes on the CUDA card:

  * BMI — bitmap-index query "users active every day this month",
  * BW  — BitWeaving predicate scan count(*) where c1 <= v <= c2,

plus the graph set-intersection (triangle counting), with PuM latency from
the calibrated cost model vs this host's NumPy time for context. Each
kernel checks its result against NumPy itself.
"""

from __future__ import annotations

import time

import numpy as np

import repro_torch.pum as pum
from repro_torch.core import realworld


def main(device: str = "cuda", n_users: int = 8_000_000, days: int = 30,
         n_rows: int = 1_000_000, n_vertices: int = 96) -> dict:
    """Run the three workloads on ``device`` at the given sizes (the
    defaults are the reference example's) and return, per workload, its
    result and wall time in seconds; the device's cost-plane summary
    comes back under ``"stats"``."""
    rng = np.random.default_rng(7)
    out = {}
    # fuse=True is the EngineConfig default: op chains record into one
    # fused program per materialization; results and cost-plane numbers
    # are identical to eager mode. The `with` scope auto-flushes on exit.
    with pum.device(mfr="M", width=32, banks=16, device=device) as dev:
        print("== Bitmap index (BMI): daily-active-users query ==")
        bitmaps = rng.integers(0, 2**63, (days, n_users // 64),
                               dtype=np.uint64)
        t = time.perf_counter()
        count, pum_ms, cpu_ms = realworld.bmi_active_users(dev, bitmaps)
        out["bmi"] = (count, time.perf_counter() - t)
        print(f"{n_users:,} users x {days} days -> {count:,} always-active")
        print(f"PuM {pum_ms:.2f} ms (16 banks) | host numpy {cpu_ms:.2f} ms")

        print("\n== BitWeaving scan: count(*) where 10_000 <= v <= 60_000 ==")
        col = rng.integers(0, 100_000, n_rows, dtype=np.uint64)
        t = time.perf_counter()
        count, pum_ms, cpu_ms = realworld.bitweaving_scan(dev, col,
                                                          10_000, 60_000)
        out["bitweaving"] = (count, time.perf_counter() - t)
        print(f"{n_rows:,}-row column -> {count:,} matches")
        print(f"PuM {pum_ms:.2f} ms | host numpy {cpu_ms:.2f} ms")

        print("\n== Triangle counting (set-centric AND + popcount) ==")
        n = n_vertices
        adj = np.triu((rng.random((n, n)) < 0.15).astype(np.uint8), 1)
        t = time.perf_counter()
        tri, pum_ms, cpu_ms = realworld.triangle_count(dev, adj + adj.T)
        out["triangle_count"] = (tri, time.perf_counter() - t)
        print(f"{n}-vertex graph -> {tri} triangles")
        print(f"PuM {pum_ms:.2f} ms | host numpy {cpu_ms:.2f} ms")

        st = dev.stats
        out["stats"] = st
        print(f"\ndevice session on {dev.torch_device}: {st.n_sequences:,} "
              f"row-activation sequences, stable-lane efficiency "
              f"{st.lane_efficiency:.3f}")
    return out


if __name__ == "__main__":
    main()
