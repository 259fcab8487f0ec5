"""Reliability sweep: success rate + retry overhead vs injected variation.

One fused app-style program (the test suite's mixed logic/arith/compare
kernel, 512 lanes x 16 bits) runs against calibrated chips of decreasing
lot quality: process variation scaled up from the manufacturer nominal,
flip probabilities scaled by ``flip_scale`` (weak-lot model). Per point
the derived string reports the calibrated chip-wide success rate at the
flush config, fault/correction counts, retry + escalation overhead,
oracle fallbacks, and the bit-exactness flag (which must always be 1 —
the vote/retry loop degrades to the eager oracle rather than return a
wrong bit). The per-row telemetry counters ride along into
``BENCH_reliability.json``; ``tools/bench_compare.py --check-rows``
gates the row set in CI.

Steering is disabled in the injected rows so the sweep measures the
raw correction machinery (with steering on, this workload fits entirely
in the strong subarrays — that effect gets its own ablation row pair).

The PyTorch port's counterpart of ``benchmarks/reliability_sweep.py``:
the same rows and ``derived`` strings, every device on ``device``. On a
CUDA card the calibrations run the charge-sharing kernel, the replica
votes the MAJ-N kernel and the flushes the bit-transpose and
fused-program kernels. ``seed`` offsets every device's seed (the
reference's 7), which draws another chip and other faults.
"""

from __future__ import annotations

import numpy as np

from benchmarks.common import Row, record_counters, row, timed_us
from repro_torch import pum
from repro_torch.core.profiles import PROFILES

WIDTH = 16
LANES = 512
CAL = dict(n_subarrays=4, n_columns=64, n_patterns=4)
PV_NOMINAL = PROFILES["M"].process_variation


def _device(device, seed: int, **kw):
    args = dict(mfr="M", width=WIDTH, banks=4, fuse=True, seed=7 + seed,
                device=device)
    args.update(kw)
    return pum.Device(**args)


def _workload(dev, a, b):
    x, y = dev.asarray(a), dev.asarray(b)
    out = (x & y) ^ (x + y)
    lt = x < y
    dev.flush()
    return out.to_numpy(), lt.to_numpy()


def _rel_counters(dev) -> dict:
    c = dev.counters.as_dict()["counters"]
    return {k.split(".", 1)[1]: v for k, v in c.items()
            if k.startswith("reliability.")}


def run(device="cuda", seed: int = 0) -> list[Row]:
    rng = np.random.default_rng(2026)
    a = rng.integers(0, 1 << WIDTH, LANES, np.uint64)
    b = rng.integers(0, 1 << WIDTH, LANES, np.uint64)

    rows: list[Row] = []

    # Clean fused reference: the eager-oracle values every other row is
    # checked against, plus the uninstrumented wall time.
    base_dev = _device(device, seed)
    us, want = timed_us(_workload, base_dev, a, b)
    rows.append(row("rel.baseline", us,
                    f"lanes={LANES} width={WIDTH} inject=off map=off"))

    # Calibration pass cost (the one-time profile of the simulated chip).
    cal_dev = _device(device, seed)
    us, rmap = timed_us(lambda: cal_dev.calibrate(attach=False, **CAL),
                        repeat=1)
    rows.append(row(
        "rel.calibrate", us,
        f"banks=4 subarrays={CAL['n_subarrays']} "
        f"columns={CAL['n_columns']} configs={len(rmap.configs)} "
        f"mean_success={np.mean(rmap.success):.4f}"))

    # Map attached, injection off: variation-aware planning only. Must be
    # bit-exact with zero reliability counters (the zero-overhead claim).
    plan_dev = _device(device, seed)
    plan_dev.calibrate(process_variation=PV_NOMINAL * 3, **CAL)
    us, got = timed_us(_workload, plan_dev, a, b)
    exact = int(all(np.array_equal(g, w) for g, w in zip(got, want)))
    rows.append(row(
        "rel.plan_only", us,
        f"exact={exact} counters={len(_rel_counters(plan_dev))} "
        f"(map-guided fig11 replication, no injection)"))

    # Injection sweep: lot quality degrades left to right.
    for tag, pv_scale, flip_scale in (
            ("pv3_fs10", 3.0, 10.0),
            ("pv5_fs40", 5.0, 40.0),
            ("pv6_fs10", 6.0, 10.0)):
        dev = _device(device, seed)
        dev.calibrate(inject=True, steer=False,
                      process_variation=PV_NOMINAL * pv_scale,
                      flip_scale=flip_scale, **CAL)
        m, n = dev.reliability._flush_config()
        success = dev.reliability.map.mean_success(m, n)
        us, got = timed_us(_workload, dev, a, b, repeat=1)
        exact = int(all(np.array_equal(g, w) for g, w in zip(got, want)))
        c = _rel_counters(dev)
        flushes = max(1, c.get("flushes", 0))
        name = f"rel.inject_{tag}"
        rows.append(row(
            name, us,
            f"exact={exact} success={success:.4f} "
            f"injected={c.get('injected_bits', 0)} "
            f"corrected={c.get('corrected_bits', 0)} "
            f"weak={c.get('weak_bits', 0)} "
            f"retries_per_flush={c.get('retries', 0) / flushes:.2f} "
            f"escalations={c.get('escalations', 0)} "
            f"fallbacks={c.get('oracle_fallbacks', 0)} "
            f"votes={c.get('votes_run', 0)}"))
        record_counters(name, dev.counters)

    # Steering ablation at the pv5/fs40 point: same chip, same workload,
    # map-guided placement on vs off.
    injected = {}
    for steer in (True, False):
        dev = _device(device, seed)
        dev.calibrate(inject=True, steer=steer,
                      process_variation=PV_NOMINAL * 5, flip_scale=40.0,
                      **CAL)
        _workload(dev, a, b)
        injected[steer] = _rel_counters(dev).get("injected_bits", 0)
    rows.append(row(
        "rel.steer_ablation", 0.01,
        f"injected_steered={injected[True]} "
        f"injected_unsteered={injected[False]} "
        f"(weak-column steering avoids "
        f"{injected[False] - injected[True]} faults)"))
    return rows
