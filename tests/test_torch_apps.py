"""The port's Fig 20 app kernels against the reference, on the CPU.

Every kernel of ``repro_torch.core.realworld`` runs beside
``repro.core.realworld`` on the same seeded inputs, at the sizes of
``tests/core/test_cost_and_apps.py``, eager and fused: results equal,
latencies equal and ``EngineStats.as_dict()`` identical (tolerance 0) —
also at ``benchmarks/fig20_realworld.py``'s configuration (a shared
``MemoryController``, PULSAR and its FracDRAM twin). The committed
``fig20_*`` entries of ``tests/controller/golden_costs.json`` are
reproduced float for float, ``_KCS_MEMO`` invalidates on an in-place
rewrite of the adjacency, and ``repro_torch.examples.pum_database`` runs
at a reduced size with the reference's results and stats.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np
import pytest

import repro.pum as rpum
import repro_torch.pum as tpum
from repro.controller import MemoryController as RefController
from repro.core import realworld as rrw
from repro_torch.controller import MemoryController as PortController
from repro_torch.core import engine as tengine
from repro_torch.core import realworld as trw

FIXTURE = pathlib.Path(__file__).parent / "controller" / "golden_costs.json"
FUSE = [False, True]


def _adjacency(rng, n, p):
    adj = np.triu((rng.random((n, n)) < p).astype(np.uint8), 1)
    return adj + adj.T


def _app_cases():
    """name -> (device overrides, fn(realworld, dev) -> kernel result), on
    the inputs of tests/core/test_cost_and_apps.py."""
    bitmaps = np.random.default_rng(2).integers(0, 2**64, (30, 128),
                                                dtype=np.uint64)
    col = np.random.default_rng(3).integers(0, 1000, 4096, dtype=np.uint64)
    col16 = np.random.default_rng(9).integers(0, 1 << 16, 2048,
                                              dtype=np.uint64)
    adj = _adjacency(np.random.default_rng(4), 24, 0.3)
    rng = np.random.default_rng(5)
    q = rng.integers(0, 256, (4, 16), dtype=np.int64)
    r = rng.integers(0, 256, (64, 16), dtype=np.int64)
    img = np.random.default_rng(6).integers(0, 256, (32, 32),
                                            dtype=np.int64)
    cl_adj = _adjacency(np.random.default_rng(7), 16, 0.4)
    return {
        "bmi": ({}, lambda rw, d: rw.bmi_active_users(d, bitmaps)),
        "bitweaving": ({"width": 16},
                       lambda rw, d: rw.bitweaving_scan(d, col, 100, 500)),
        "bitweaving_from_0": ({"width": 16}, lambda rw, d:
                              rw.bitweaving_scan(d, col16, 0, 500)),
        "bitweaving_to_max": ({"width": 16}, lambda rw, d:
                              rw.bitweaving_scan(d, col16, 100, 65535)),
        "triangle_count": ({}, lambda rw, d: rw.triangle_count(d, adj)),
        "kclique_star": ({}, lambda rw, d: rw.kclique_star(
            d, cl_adj, [(0, 1, 2), (3, 4, 5)])),
        "kclique_star_ragged": ({}, lambda rw, d: rw.kclique_star(
            d, cl_adj, [(0, 1, 2), (3, 4), (5, 6, 7, 8)])),
        "knn": ({"width": 24}, lambda rw, d: rw.knn_distances(d, q, r)),
        "image_segmentation": ({"width": 16}, lambda rw, d:
                               rw.image_segmentation(
                                   d, img, np.array([10, 90, 170, 250]))),
        "xnor_conv": ({}, lambda rw, d: (None, rw.xnor_conv_cost(
            d, 128, 128, 3, 3, 16, 16), 0.0)),
    }


APPS = sorted(_app_cases())


def _same(got, want) -> None:
    if isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


@pytest.mark.parametrize("fuse", FUSE)
@pytest.mark.parametrize("app", APPS)
def test_app_kernel_matches_reference(app, fuse):
    kw, fn = _app_cases()[app]
    ref = rpum.device(mfr="M", fuse=fuse, **kw)
    port = tpum.device(mfr="M", fuse=fuse, device="cpu", **kw)
    want, want_ms, _ = fn(rrw, ref)
    got, got_ms, _ = fn(trw, port)
    _same(got, want)
    assert got_ms == want_ms and got_ms > 0
    assert port.stats.as_dict() == ref.stats.as_dict()


_CONTROLLERS: dict = {}


def _fig20_devices(pum, controller_cls, use_pulsar):
    """benchmarks/fig20_realworld.py's configuration, one shared
    controller per package."""
    ctrl = _CONTROLLERS.setdefault(controller_cls,
                                   controller_cls(n_banks=16))
    kw = {"device": "cpu"} if pum is tpum else {}
    return pum.device(pum.EngineConfig(mfr="M", width=32, banks=16,
                                       controller=ctrl,
                                       use_pulsar=use_pulsar, **kw))


@pytest.mark.parametrize("use_pulsar", [True, False])
@pytest.mark.parametrize("app", ["bmi", "triangle_count", "kclique_star",
                                 "bitweaving", "xnor_conv"])
def test_app_kernel_under_the_fig20_controller(app, use_pulsar):
    """Priced through a shared MemoryController (PULSAR and its FracDRAM
    twin): refresh stall and every other stat equal the reference's."""
    _, fn = _app_cases()[app]
    ref = _fig20_devices(rpum, RefController, use_pulsar)
    port = _fig20_devices(tpum, PortController, use_pulsar)
    want, want_ms, _ = fn(rrw, ref)
    got, got_ms, _ = fn(trw, port)
    _same(got, want)
    assert got_ms == want_ms
    assert port.stats.as_dict() == ref.stats.as_dict()
    assert port.stats.refresh_stall_ns > 0


def test_fig20_golden_entries_reproduced():
    """``golden_costs.json``'s ``fig20_*`` entries, float for float, from
    the fixture's own workloads run on the port."""
    fix = json.loads(FIXTURE.read_text())
    rng = np.random.default_rng(0)
    bitmaps = (rng.integers(0, 1 << 63, (7, 64), dtype=np.uint64)
               | rng.integers(0, 1 << 63, (7, 64), dtype=np.uint64))
    dev = tpum.device(width=64, fuse=True, device="cpu")
    got, _, _ = trw.bmi_active_users(dev, bitmaps)
    bmi = {"result": got, "latency_ns": dev.stats.latency_ns,
           "energy_j": dev.stats.energy_j,
           "n_sequences": dev.stats.n_sequences}
    col = rng.integers(0, 1 << 20, 4096, dtype=np.uint64)
    dev2 = tpum.device(width=32, fuse=True, device="cpu")
    got, _, _ = trw.bitweaving_scan(dev2, col, 1000, 800000)
    bw = {"result": got, "latency_ns": dev2.stats.latency_ns,
          "energy_j": dev2.stats.energy_j,
          "n_sequences": dev2.stats.n_sequences}
    assert bmi == fix["fig20_bmi_active_users"]
    assert bw == fix["fig20_bitweaving_scan"]


def test_kcs_memo_hits_then_invalidates_on_inplace_rewrite(monkeypatch):
    """A repeat call reuses the memoized operands (the leaf cache then
    stages and uploads nothing); an in-place rewrite of the adjacency
    misses the memo, and both packages count the rewritten graph."""
    uploads = []
    real = tengine._upload
    monkeypatch.setattr(tengine, "_upload",
                        lambda w, d: uploads.append(w.nbytes) or real(w, d))
    adj = _adjacency(np.random.default_rng(11), 32, 0.4)
    cliques = [(0, 1, 2), (3, 4, 5), (6, 7, 8)]
    port = tpum.device(mfr="M", device="cpu")
    ref = rpum.device(mfr="M")
    first = trw.kclique_star(port, adj, cliques)[0]
    assert uploads and first == rrw.kclique_star(ref, adj, cliques)[0]
    operands = trw._kcs_operands(adj, cliques)
    uploads.clear()
    assert trw.kclique_star(port, adj, cliques)[0] == first
    assert uploads == []
    assert trw._kcs_operands(adj, cliques)[0] is operands[0]
    # Rewrite the adjacency in place: vertex 9 joins every clique.
    adj[9, :9] = adj[:9, 9] = 1
    assert trw._kcs_operands(adj, cliques)[0] is not operands[0]
    got = trw.kclique_star(port, adj, cliques)[0]
    assert got == rrw.kclique_star(ref, adj, cliques)[0] and got > first
    assert port.stats.as_dict() == ref.stats.as_dict()


def test_pum_database_example_at_reduced_size():
    from repro_torch.examples import pum_database
    sizes = dict(n_users=64 * 512, days=6, n_rows=8192, n_vertices=24)
    out = pum_database.main(device="cpu", **sizes)
    # The same workloads on the reference, drawn from the example's seed.
    rng = np.random.default_rng(7)
    ref = rpum.device(mfr="M", width=32, banks=16)
    bitmaps = rng.integers(0, 2**63, (6, 512), dtype=np.uint64)
    want = {"bmi": rrw.bmi_active_users(ref, bitmaps)[0]}
    col = rng.integers(0, 100_000, 8192, dtype=np.uint64)
    want["bitweaving"] = rrw.bitweaving_scan(ref, col, 10_000, 60_000)[0]
    adj = np.triu((rng.random((24, 24)) < 0.15).astype(np.uint8), 1)
    want["triangle_count"] = rrw.triangle_count(ref, adj + adj.T)[0]
    assert {k: out[k][0] for k in want} == want
    assert all(out[k][1] >= 0 for k in want)
    assert out["stats"].as_dict() == ref.stats.as_dict()
