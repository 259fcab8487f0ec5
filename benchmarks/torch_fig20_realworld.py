"""Fig 20 (Appendix B): real-world kernels on the PuM engine — PULSAR vs
FracDRAM-configured engine vs this host's NumPy as the CPU reference.

Bank-level parallelism is priced through the MemoryController: PULSAR:16
uses all 16 banks, but the scheduled trace caps effective parallelism at
what tFAW/tRRD allow and adds the tREFI/tRFC refresh-interference stall
(reported per kernel as ``refresh=``; the paper's best configuration is
1.59x over FracDRAM:16 / 43x over CPU on their Skylake).

The PyTorch port's counterpart of ``benchmarks/fig20_realworld.py``: the
same rows and ``derived`` strings; the devices lie on ``device``, where a
CUDA card runs every fused flush through the bit-transpose and
fused-program kernels. ``host_numpy=`` is this host's NumPy wall."""

from __future__ import annotations

import numpy as np

import repro_torch.pum as pum
from benchmarks.common import Row, row
from repro_torch.controller import MemoryController
from repro_torch.core import realworld


def _devices(device, controllers: dict, trefi: float | None = None):
    # One controller per tREFI, shared across a run's devices/kernels: it is
    # stateless across schedule() calls and its batch_cost cache makes
    # repeat pricing free.
    if trefi not in controllers:
        controllers[trefi] = MemoryController(n_banks=16, trefi=trefi)
    ctrl = controllers[trefi]
    # fuse=True (the EngineConfig default): the app kernels execute through
    # the fused dataplane (bit-exact, cost plane invariant — the reported
    # latencies are unchanged; the host-side dataplane just compiles to
    # fewer passes). One PULSAR device + one FracDRAM-configured twin.
    cfg = pum.EngineConfig(mfr="M", width=32, banks=16, controller=ctrl,
                           device=device)
    return (pum.device(cfg), pum.device(cfg.replace(use_pulsar=False)))


def run(device="cuda") -> list[Row]:
    rng = np.random.default_rng(20)
    rows: list[Row] = []
    controllers: dict[float | None, MemoryController] = {}

    def emit(name, fn, *args, **kw):
        pul, frac = _devices(device, controllers)
        _, p_ms, cpu_ms = fn(pul, *args, **kw)
        _, f_ms, _ = fn(frac, *args, **kw)
        r_ms = pul.stats.refresh_stall_ns * 1e-6
        rows.append(row(
            f"fig20.{name}", p_ms * 1e3,
            f"pulsar={p_ms:.3f}ms frac={f_ms:.3f}ms host_numpy={cpu_ms:.3f}ms "
            f"pulsar_vs_frac={f_ms/max(p_ms,1e-9):.2f}x "
            f"refresh={r_ms:.4f}ms"))

    bitmaps = rng.integers(0, 2**63, (30, 1024), dtype=np.uint64)
    emit("bmi", realworld.bmi_active_users, bitmaps)
    col = rng.integers(0, 100000, 65536, dtype=np.uint64)
    emit("bitweaving", realworld.bitweaving_scan, col, 1000, 60000)
    n = 48
    adj = np.triu((rng.random((n, n)) < 0.25).astype(np.uint8), 1)
    emit("triangle_count", realworld.triangle_count, adj + adj.T)
    cl_adj = np.triu((rng.random((32, 32)) < 0.4).astype(np.uint8), 1)
    cl_adj = cl_adj + cl_adj.T
    cliques = [(0, 1, 2), (3, 4, 5), (6, 7, 8)]
    emit("kclique_star", realworld.kclique_star, cl_adj, cliques)
    q = rng.integers(0, 256, (8, 32), dtype=np.int64)
    r = rng.integers(0, 256, (256, 32), dtype=np.int64)
    emit("knn", realworld.knn_distances, q, r)
    img = rng.integers(0, 256, (64, 64), dtype=np.int64)
    emit("image_seg", realworld.image_segmentation, img,
         np.array([20, 90, 160, 230]))

    # XNOR-Net conv layers (op-count model): LeNet-5 + VGG-13-ish layer.
    pul, frac = _devices(device, controllers)
    for name, spec in {"xnor_lenet_c3": (6, 16, 5, 5, 10, 10),
                       "xnor_vgg_l5": (256, 256, 3, 3, 8, 8)}.items():
        p_ms = realworld.xnor_conv_cost(pul, *spec)
        f_ms = realworld.xnor_conv_cost(frac, *spec)
        rows.append(row(f"fig20.{name}", p_ms * 1e3,
                        f"pulsar={p_ms:.3f}ms frac={f_ms:.3f}ms "
                        f"ratio={f_ms/max(p_ms,1e-9):.2f}x "
                        f"refresh={pul.stats.refresh_stall_ns*1e-6:.4f}ms"))

    # Refresh interference is tREFI-dependent: halving tREFI (hot-temp 2x
    # refresh) roughly doubles the REF stall on the same kernel.
    for trefi in (7800.0, 3900.0):
        pul, _ = _devices(device, controllers, trefi=trefi)
        _, p_ms, _ = realworld.bmi_active_users(pul, bitmaps)
        rows.append(row(
            f"fig20.refresh_trefi{int(trefi)}", p_ms * 1e3,
            f"pulsar={p_ms:.3f}ms "
            f"refresh={pul.stats.refresh_stall_ns*1e-6:.4f}ms "
            f"trefi={trefi}ns"))
    return rows
