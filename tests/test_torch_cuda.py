"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test needs a CUDA card and ``nvcc`` and skips with
a reason elsewhere (whether a card is present is decided inside the
test, never at import). On a GPU host:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.convert import program_from_reference
from repro_torch.core.profiles import MFR_H
from repro_torch.kernels import fused_program as tfp
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("g", [1, 7, 1000, 65536])
def test_bit_transpose_kernel_matches_plain(cuda, g):
    x = torch.randint(-2**31, 2**31 - 1, (32, g), dtype=torch.int32,
                      device=cuda)
    before = ops.LAUNCHES["bit_transpose32"]
    got = ops.bit_transpose32(x)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.bit_transpose32(x))
    assert ops.LAUNCHES["bit_transpose32"] == before + 1


@pytest.mark.parametrize("width", [8, 16, 32, 33, 64])
def test_fused_program_kernel_matches_plain(cuda, width):
    from test_torch_fused_program import random_program
    rng = np.random.default_rng(width)
    prog = program_from_reference(*random_program(rng, width),
                                  32 if width <= 32 else 64)
    x = torch.randint(-2**31, 2**31 - 1, (3, width, 3000),
                      dtype=torch.int32, device=cuda)
    x[1, :, :100] = 0  # zero divisors
    before = ops.LAUNCHES["run_program_cuda"]
    got = ops.run_fused_program(prog, x)
    torch.cuda.synchronize()
    assert torch.equal(got, tfp.run_program_ref(prog, x))
    assert ops.LAUNCHES["run_program_cuda"] == before + 1


def test_engine_on_the_card_matches_host(cuda):
    import repro_torch.pum as pum
    from test_torch_cost_plane import prog16
    rng = np.random.default_rng(1)
    a, b, c = (rng.integers(0, 2**32, 1 << 16, dtype=np.uint64)
               for _ in range(3))
    dev = pum.device(width=32)
    host = pum.device(width=32, fuse=False)
    np.testing.assert_array_equal(prog16(dev, a, b, c).to_numpy(),
                                  prog16(host, a, b, c).to_numpy())
    assert dev.stats == host.stats


@pytest.mark.parametrize("n", [1, 3, 5, 7, 17, 32])
@pytest.mark.parametrize("w", [1, 1000, 65536])
def test_maj_n_kernel_matches_plain(cuda, n, w):
    x = torch.randint(-2**31, 2**31 - 1, (n, w), dtype=torch.int32,
                      device=cuda)
    for t in sorted({1, n // 2 + 1, n}):
        before = ops.LAUNCHES["maj_n"]
        got = ops.maj_n(x, t)
        torch.cuda.synchronize()
        assert torch.equal(got, ref.maj_n_fast(x, t))
        assert torch.equal(got, ref.maj_n(x, t))
        assert ops.LAUNCHES["maj_n"] == before + 1


@pytest.mark.parametrize("n", range(1, 33))
def test_maj_n_kernel_at_the_chip_shape(cuda, n):
    """The chip model's votes: [N, 2048] (a PAPER_MODULE row) at every
    threshold, one launch a call."""
    x = torch.randint(-2**31, 2**31 - 1, (n, 2048), dtype=torch.int32,
                      device=cuda)
    x[:, :7] = -1
    for t in range(1, n + 1):
        before = ops.LAUNCHES["maj_n"]
        got = ops.maj_n(x, t)
        torch.cuda.synchronize()
        assert torch.equal(got, ref.maj_n_fast(x, t)), t
        assert ops.LAUNCHES["maj_n"] == before + 1
    assert torch.equal(got, ref.maj_n(x, n))


@pytest.mark.parametrize("n", [33, 255, 4096])
@pytest.mark.parametrize("w", [1, 31, 2049])
def test_maj_n_kernel_ragged_and_many_planes(cuda, n, w):
    """Ragged widths (4-byte loads) and many row groups; the plain
    version runs on the CPU copy (N = 4096 is 160K small ops)."""
    x = torch.randint(-2**31, 2**31 - 1, (n, w), dtype=torch.int32,
                      device=cuda)
    x[:, :5] = -1
    for t in sorted({1, n // 2 + 1, n}):
        before = ops.LAUNCHES["maj_n"]
        got = ops.maj_n(x, t)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), ref.maj_n_fast(x.cpu(), t)), t
        assert torch.equal(got, ref.maj_n(x, t)), t
        assert ops.LAUNCHES["maj_n"] == before + 1


@pytest.mark.parametrize("n,w,groups,tile", [
    (8, 64, 0, 16), (8, 64, 9, 16), (8, 64, 1, 6), (8, 64, 1, 2),
    (8, 64, 2, 1024), (65535, 512, 2, 512)])
def test_maj_n_launch_refuses_a_bad_geometry(cuda, n, w, groups, tile):
    """No row group, more groups than planes, a tile that is not whole
    16-byte loads, more than 256 threads, the merge past 48 KB of shared
    memory: refused with cudaErrorInvalidValue, nothing launched."""
    from repro_torch.kernels import _build, maj_n
    x = torch.zeros((n, w), dtype=torch.int32, device=cuda)
    out = torch.full((w,), 7, dtype=torch.int32, device=cuda)
    lib = maj_n.library()
    rc = lib.maj_n_launch(x.data_ptr(), out.data_ptr(), n, w, 1, groups,
                          tile, _build.stream_of(x))
    torch.cuda.synchronize()
    assert rc == 1  # cudaErrorInvalidValue
    assert bool((out == 7).all())


@pytest.mark.parametrize("p", [None, 12])
@pytest.mark.parametrize("n,b", [(4, 65536), (32, 65536), (9, 1001)])
def test_charge_share_kernel_matches_plain(cuda, p, n, b):
    g = torch.Generator(device=cuda).manual_seed(n * b)
    shape = (n, b) if p is None else (p, n, b)
    v = (torch.rand(shape, generator=g, device=cuda) < 0.5).float() * 1.2
    caps = 20 * (1 + 0.2 * torch.randn((n, b), generator=g, device=cuda))
    before = ops.LAUNCHES["charge_share"]
    got = ops.charge_share(v, caps, vdd=MFR_H.vdd, c_bl=MFR_H.bitline_cap_ff)
    torch.cuda.synchronize()
    want = ref.charge_share(v, caps, vdd=MFR_H.vdd, c_bl=MFR_H.bitline_cap_ff)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)
    assert ops.LAUNCHES["charge_share"] == before + 1


def test_injected_flush_on_the_card_is_bit_exact(cuda):
    import repro_torch.pum as pum
    from test_torch_cost_plane import prog16
    rng = np.random.default_rng(2)
    a, b, c = (rng.integers(0, 2**32, 1 << 14, dtype=np.uint64)
               for _ in range(3))
    dev = pum.device(width=32, banks=4)
    before = dict(ops.LAUNCHES)
    dev.calibrate(inject=True, n_columns=512, flip_scale=1e4, steer=False)
    assert ops.LAUNCHES["charge_share"] > before.get("charge_share", 0)
    host = pum.device(width=32, banks=4, fuse=False)
    np.testing.assert_array_equal(prog16(dev, a, b, c).to_numpy(),
                                  prog16(host, a, b, c).to_numpy())
    assert ops.LAUNCHES["maj_n"] > before.get("maj_n", 0)
    assert dev.counters.get("reliability.injected_bits") > 0


@pytest.mark.parametrize("n", [33, 35, 64, 255])
def test_maj_n_kernel_past_32_planes(cuda, n):
    """K3's counter takes K = bit_length(N) up to 16: votes of any R the
    reliability policy escalates to."""
    x = torch.randint(-2**31, 2**31 - 1, (n, 4099), dtype=torch.int32,
                      device=cuda)
    x[:, :5] = -1
    for t in sorted({1, n // 2 + 1, n}):
        got = ops.maj_n(x, t)
        torch.cuda.synchronize()
        assert torch.equal(got, ref.maj_n_fast(x, t))


@pytest.mark.parametrize("width", [1, 8, 32, 33, 64])
@pytest.mark.parametrize("w", [1, 1001, 65536])
def test_bitserial_add_kernel_matches_plain(cuda, width, w):
    a = torch.randint(-2**31, 2**31 - 1, (width, w), dtype=torch.int32,
                      device=cuda)
    b = torch.randint(-2**31, 2**31 - 1, (width, w), dtype=torch.int32,
                      device=cuda)
    a[:, :1] = -1  # a carry through every plane
    before = ops.LAUNCHES["bitserial_add"]
    got = ops.bitserial_add(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.bitserial_add(a, b))
    assert ops.LAUNCHES["bitserial_add"] == before + 1


def _alu_add_on(device):
    from repro_torch.core.alu import BitSerialAlu
    from repro_torch.core.chip import PulsarChip
    from repro_torch.core.decoder import RowDecoder
    from repro_torch.core.geometry import DramGeometry
    from repro_torch.core.pulsar import PulsarExecutor
    geom = DramGeometry(row_bits=4096, rows_per_subarray=512,
                        subarrays_per_bank=2, banks=1)
    chip = PulsarChip(geom, MFR_H, seed=0, trace=True, device=device)
    chip.decoder = RowDecoder(geom, MFR_H, None)
    alu = BitSerialAlu(PulsarExecutor(chip, 0, 0), width=16)
    rng = np.random.default_rng(3)
    a, b = (rng.integers(0, 1 << 16, 4096, dtype=np.uint64) for _ in range(2))
    va, vb = alu.load(a), alu.load(b)
    s = alu.add(va, vb)
    np.testing.assert_array_equal(alu.store(s), (a + b) & 0xFFFF)
    return chip, alu, (va, vb, s)


def test_chip_on_the_card_matches_cpu_after_alu_add(cuda):
    import dataclasses
    before = ops.LAUNCHES["maj_n"]
    chip, alu, vecs = _alu_add_on("cuda")
    n_apa = sum(1 for name, _ in chip.stats.trace
                if name.startswith("apa_maj"))
    assert ops.LAUNCHES["maj_n"] - before == n_apa > 0
    host, host_alu, _ = _alu_add_on("cpu")
    assert torch.equal(chip.banks.cpu(), host.banks)
    np.testing.assert_array_equal(chip.neutral, host.neutral)
    assert dataclasses.asdict(chip.stats) == dataclasses.asdict(host.stats)
    assert alu.op_counts == host_alu.op_counts
    va, vb, s = (torch.stack([chip.peek(0, r) for r in v.pos_rows])
                 for v in vecs)
    assert torch.equal(ops.bitserial_add(va, vb), s)


def test_sim_device_on_the_card_matches_cpu(cuda):
    import repro_torch.pum as pum
    rng = np.random.default_rng(4)
    dev = pum.device(mfr="H", width=8, backend="sim")
    host = pum.device(mfr="H", width=8, backend="sim", device="cpu")
    assert dev.engine._alu.chip.device.type == "cuda"
    n = dev.engine._alu.words * 32
    a, b = (rng.integers(0, 256, n, dtype=np.uint64) for _ in range(2))
    b[::3] = 0
    outs = []
    for d in (dev, host):
        x = d.asarray(a)
        outs.append([np.asarray(op) for op in (x + b, x * b, x // b, x % b,
                                               x ^ b)])
    for g, w in zip(*outs):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(outs[0][2],
                                  np.where(b == 0, 0, a // np.maximum(b, 1)))
    assert dev.stats.as_dict() == host.stats.as_dict()


def test_flush_async_from_a_side_stream(cuda):
    """The flush worker dispatches under the caller's device and current
    stream: a client recording under ``torch.cuda.stream(side)`` gets its
    uploads and K1/K2 launches on ``side``."""
    import threading
    import repro_torch.pum as pum
    from repro_torch.kernels import _build
    from test_torch_cost_plane import prog16
    rng = np.random.default_rng(7)
    a, b, c = (rng.integers(0, 2**32, 1 << 16, dtype=np.uint64)
               for _ in range(3))
    host = prog16(pum.device(width=32, fuse=False), a, b, c).to_numpy()
    dev = pum.device(width=32)
    side = torch.cuda.Stream()
    seen = []
    real = _build.stream_of

    def stream_of(x):
        h = real(x)
        if threading.current_thread().name.startswith("pum-flush"):
            seen.append(h)
        return h

    _build.stream_of = stream_of
    try:
        with dev.client("side"), torch.cuda.stream(side):
            t = prog16(dev, a, b, c)
            dev.flush_async().result(timeout=120)
    finally:
        _build.stream_of = real
    dev.close()
    assert seen and set(seen) == {side.cuda_stream}
    np.testing.assert_array_equal(t.to_numpy(), host)


@pytest.mark.parametrize("engine_card,caller_card", [(1, 0), (0, 1)])
def test_flush_async_engine_on_another_card(engine_card, caller_card):
    """An engine on one card flushed asynchronously from a caller whose
    current device is the other: the worker launches on the engine's
    card."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    import repro_torch.pum as pum
    from repro_torch.kernels import _build
    a = np.arange(1 << 12, dtype=np.uint64)
    dev = pum.device(width=32, device=f"cuda:{engine_card}")
    devices = []
    real = _build.stream_of

    def stream_of(x):
        devices.append((x.device, torch.cuda.current_device()))
        return real(x)

    _build.stream_of = stream_of
    try:
        with torch.cuda.device(caller_card):
            t = (dev.asarray(a) + a) * a
            dev.flush_async().result(timeout=120)
    finally:
        _build.stream_of = real
    dev.close()
    assert devices and all(
        d == torch.device("cuda", engine_card) and cur == engine_card
        for d, cur in devices)
    np.testing.assert_array_equal(t.to_numpy(),
                                  ((2 * a) * a) & np.uint64(0xFFFFFFFF))


def test_capture_on_the_card(cuda):
    """Replays on the card equal the host, launch the fused-program kernel
    once each and keep stats equal to re-recording."""
    import repro_torch.pum as pum
    from repro_torch.kernels import _build
    from test_torch_cost_plane import prog16
    rng = np.random.default_rng(8)
    a, b, c = (rng.integers(0, 2**32, 1 << 16, dtype=np.uint64)
               for _ in range(3))
    host = pum.device(width=32, device="cpu")
    want = prog16(host, a, b, c).to_numpy()
    dev = pum.device(width=32)
    prog = dev.capture(lambda x, y, z: prog16(dev, x, y, z))
    np.testing.assert_array_equal(prog(a, b, c), want)
    for _ in range(3):
        before = _build.LAUNCHES["run_program_cuda"]
        np.testing.assert_array_equal(prog(a, b, c), want)
        assert _build.LAUNCHES["run_program_cuda"] == before + 1
    for _ in range(3):
        prog16(host, a, b, c).to_numpy()
    assert prog.n_records == 1 and prog.n_replays == 3
    assert dev.stats == host.stats
    dev.close()


def test_controller_device_on_the_card(cuda):
    """``controller="auto"`` on the card: outputs and controller-priced
    ``EngineStats`` (refresh stall included) equal the CPU device's."""
    import repro_torch.pum as pum
    from test_torch_cost_plane import prog16
    rng = np.random.default_rng(9)
    a, b, c = (rng.integers(0, 2**16, 1 << 16, dtype=np.uint64)
               for _ in range(3))
    devs = [pum.device(width=16, controller="auto"),
            pum.device(width=16, controller="auto", device="cpu")]
    outs = [prog16(d, a, b, c).to_numpy() for d in devs]
    np.testing.assert_array_equal(outs[0], outs[1])
    assert devs[0].stats.as_dict() == devs[1].stats.as_dict()
    assert devs[0].stats.refresh_stall_ns > 0


@pytest.mark.parametrize("app", ["bmi", "bitweaving", "triangle_count",
                                 "kclique_star", "knn",
                                 "image_segmentation"])
def test_app_kernel_on_the_card(cuda, app):
    """A Fig 20 app kernel on a CUDA device: its own NumPy check passes
    and its result and ``EngineStats`` equal a CPU device's."""
    import repro_torch.pum as pum
    from repro_torch.core import realworld
    from repro_torch.kernels import _build
    from test_torch_apps import _app_cases
    kw, fn = _app_cases()[app]
    before = _build.LAUNCHES["run_program_cuda"]
    dev = pum.device(mfr="M", **kw)
    host = pum.device(mfr="M", device="cpu", **kw)
    got, got_ms, _ = fn(realworld, dev)
    want, want_ms, _ = fn(realworld, host)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert got_ms == want_ms
    assert dev.stats.as_dict() == host.stats.as_dict()
    assert _build.LAUNCHES["run_program_cuda"] > before


def test_autotune_on_the_card_picks_the_kernels(cuda):
    """Offline autotune on a CUDA device searches the hand-written
    kernels' backends; the tuned device stays bit-exact and
    stats-identical to a static one, across a live 32 -> 64 flip."""
    import repro_torch.pum as pum
    from repro_torch.autotune import TunedPlan
    from test_torch_autotune import run_workload
    static = pum.device(width=32)
    want = run_workload(static, 32)
    dev = pum.device(width=32)
    with pum.profile(dev):
        run_workload(dev, 32, seed=3)
    plan = dev.autotune(apply=True)
    assert plan.fused_backend in ("vertical-cuda", "vertical-cuda-64")
    dev.reset_stats()
    for g, w in zip(run_workload(dev, 32), want):
        np.testing.assert_array_equal(g, w)
    assert dev.stats.as_dict() == static.stats.as_dict()
    dev._apply_plan(TunedPlan(fused_backend="vertical-cuda-64",
                              word_bits=64))
    assert dev.layout.word_bits == 64
    dev.reset_stats()
    static.reset_stats()
    want = run_workload(static, 32)
    for g, w in zip(run_workload(dev, 32), want):
        np.testing.assert_array_equal(g, w)
    assert dev.stats.as_dict() == static.stats.as_dict()


def test_autotune_under_injection_on_the_card(cuda):
    """Tuned against static with fault injection on the card: the replica
    vote runs on the MAJ-N kernel on both sides, outputs stay bit-exact
    and ``EngineStats`` equal."""
    import repro_torch.pum as pum
    from repro_torch.kernels import _build
    from test_torch_autotune import run_workload
    rmap = pum.calibrate("M", banks=16, n_subarrays=2, n_columns=32,
                         n_patterns=2, seed=13, device="cuda")
    rcfg = pum.ReliabilityConfig(map=rmap, inject=True, seed=5)
    static = pum.device(width=32, reliability=rcfg)
    want = run_workload(static, 32)
    dev = pum.device(width=32, reliability=rcfg)
    with pum.profile(dev):
        run_workload(dev, 32, seed=3)
    plan = dev.autotune(apply=True)
    assert plan.fused_backend in ("vertical-cuda", "vertical-cuda-64")
    dev.reset_stats()
    before = _build.LAUNCHES["maj_n"]
    for g, w in zip(run_workload(dev, 32), want):
        np.testing.assert_array_equal(g, w)
    assert _build.LAUNCHES["maj_n"] > before
    assert dev.stats.as_dict() == static.stats.as_dict()


def test_online_autotune_under_flush_async_on_a_side_stream(cuda):
    """The online autotuner re-tunes from the flush worker while a client
    flushes asynchronously under a side stream; the worker's kernels stay
    on that stream and every output is bit-exact."""
    import threading
    import repro_torch.pum as pum
    from repro_torch.kernels import _build
    from repro_torch.telemetry import Tracer
    dev = pum.device(width=32)
    dev.engine.tracer = Tracer()
    dev.autotune(online=True, window_flushes=2, explore_every=1)
    side = torch.cuda.Stream()
    seen = []
    real = _build.stream_of

    def stream_of(x):
        h = real(x)
        if threading.current_thread().name.startswith("pum-flush"):
            seen.append(h)
        return h

    rng = np.random.default_rng(10)
    _build.stream_of = stream_of
    try:
        with dev.client("side"), torch.cuda.stream(side):
            for _ in range(6):
                a = rng.integers(0, 2**64, 1 << 16, dtype=np.uint64)
                b = rng.integers(0, 2**64, 1 << 16, dtype=np.uint64)
                t = (dev.asarray(a) & b) | (dev.asarray(a) ^ b)
                dev.flush_async().result(timeout=120)
                np.testing.assert_array_equal(t.to_numpy(),
                                              (a & b) | (a ^ b))
    finally:
        _build.stream_of = real
        dev.engine.tracer = None
        dev.close()
    ot = dev.engine.autotuner
    assert ot.windows == 3 and ot.retunes == 3 and not ot._busy
    assert seen and set(seen) == {side.cuda_stream}


def _serve_streams(cfg, params, device, **kw):
    from repro_torch.serve.engine import Request, ServeEngine
    eng = ServeEngine(cfg, params=params, max_batch=2, max_len=32, eos_id=3,
                      device=device, **kw)
    rng = np.random.default_rng(4)
    for rid in range(4):
        eng.submit(Request(rid=rid, prompt=rng.integers(
            0, cfg.vocab_size, 6, dtype=np.int32), max_new_tokens=5))
    done = eng.run_until_drained(max_ticks=100)
    replays = eng._stop_prog.n_replays if eng.pum is not None else 0
    eng.close()
    return sorted((r.rid, tuple(r.out_tokens)) for r in done), replays


@pytest.mark.parametrize("async_stop", [False, True])
def test_serve_engine_on_the_card_matches_cpu(cuda, async_stop):
    """Float32 smoke weights on the card and on the CPU give the same
    token streams; every replay of the stop predicate on the card is one
    fused-program launch."""
    import dataclasses
    from repro_torch.config.base import get_smoke_config
    from repro_torch.models import model as lm
    from repro_torch.models.tree import tree_map
    cfg = dataclasses.replace(get_smoke_config("qwen1.5-0.5b"),
                              dtype="float32")
    params = lm.init_params(cfg, 0, device="cpu")
    want, _ = _serve_streams(cfg, params, "cpu")
    before = ops.LAUNCHES["run_program_cuda"]
    got, replays = _serve_streams(cfg, tree_map(lambda t: t.to(cuda), params),
                                  cuda, async_stop=async_stop)
    assert got == want
    assert replays > 0
    # The warm-up call at construction records and runs the predicate
    # once; every tick after it replays.
    assert ops.LAUNCHES["run_program_cuda"] - before == replays + 1


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "hymba-1.5b",
                                  "deepseek-v2-236b", "mamba2-130m",
                                  "seamless-m4t-large-v2"])
def test_lm_on_the_card_matches_cpu(cuda, arch):
    """Prefill and decode of a float32 smoke config on the card within
    1e-4 of the CPU (matmul sum order; no TF32)."""
    import dataclasses
    from repro_torch.config.base import get_smoke_config
    from repro_torch.models import model as lm
    from repro_torch.models.tree import tree_map
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    params = lm.init_params(cfg, 0, device="cpu")
    dparams = tree_map(lambda t: t.to(cuda), params)
    rng = np.random.default_rng(5)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                    (2, 12)))}
    if cfg.encoder_decoder:
        batch["frames"] = torch.as_tensor(
            rng.standard_normal((2, 12, cfg.d_model), np.float32) * 0.02)
    want, wc, wm = lm.prefill(cfg, params, batch, 16)
    got, gc, gm = lm.prefill(cfg, dparams,
                             {k: v.to(cuda) for k, v in batch.items()}, 16)
    assert (got.cpu() - want).abs().max() < 1e-4
    for i in range(3):
        tok = want[:, :cfg.vocab_size].argmax(-1)
        pos = torch.full((2,), 12 + i)
        want, wc = lm.decode_step(cfg, params, wc, tok, pos, memory=wm)
        got, gc = lm.decode_step(cfg, dparams, gc, tok.to(cuda),
                                 pos.to(cuda), memory=gm)
        assert (got.cpu() - want).abs().max() < 1e-4


@pytest.mark.parametrize("compression", [False, True])
def test_train_step_on_the_card_matches_cpu(cuda, compression):
    """Two float32 train steps of a smoke config on the card and on the
    CPU from the same params: the loss within 1e-5 relative and every
    gradient leaf of the first step within 1e-3 of its ``max|g|``; the
    1-bit compression of those gradients on a fused card device equals an
    eager CPU device bit for bit, its bitmaps through K1 and K2."""
    import dataclasses
    from repro_torch.config.base import TrainConfig, get_smoke_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.tree import tree_items, tree_map
    from repro_torch.train import grad_compress, trainer
    import repro_torch.pum as pum
    cfg = dataclasses.replace(get_smoke_config("qwen1.5-0.5b"),
                              dtype="float32")
    tcfg = TrainConfig(warmup_steps=1, grad_compression=compression)
    host = trainer.init_train_state(cfg, tcfg, device="cpu")
    card = tuple(tree_map(lambda t: t.detach().to(cuda), s) for s in host)
    data = SyntheticLM(DataConfig(seq_len=16, global_batch=2,
                                  vocab_size=cfg.vocab_size))
    b0 = data.batch(0)
    _, _, want = trainer.loss_and_grads(cfg, tcfg, host[0],
                                        trainer.device_batch(b0, "cpu"))
    _, _, got = trainer.loss_and_grads(cfg, tcfg, card[0],
                                       trainer.device_batch(b0, cuda))
    for (path, w), (_, g) in zip(tree_items(want), tree_items(got)):
        scale = float(w.abs().max()) or 1.0
        assert float((g.cpu() - w).abs().max()) <= 1e-3 * scale, path
    step = trainer.build_train_step(cfg, tcfg)
    for i in range(2):
        batch = data.batch(i)
        _, _, hm = step(*host, trainer.device_batch(batch, "cpu"))
        _, _, cm = step(*card, trainer.device_batch(batch, cuda))
        assert abs(float(cm["loss"]) - float(hm["loss"])) <= \
            1e-5 * abs(float(hm["loss"]))
    fused = pum.device(width=32, device=cuda)
    eager = pum.device(width=32, fuse=False, device="cpu")
    before = dict(ops.LAUNCHES)
    err = grad_compress.init_error(got)
    dq, de = grad_compress.compress_grads_sign_with_feedback(got, err, fused)
    hq, he = grad_compress.compress_grads_sign_with_feedback(
        tree_map(lambda t: t.cpu(), got), tree_map(lambda t: t.cpu(), err),
        eager)
    for a, b in zip(tree_items(dq) + tree_items(de),
                    tree_items(hq) + tree_items(he)):
        assert a[1].device.type == "cuda" and torch.equal(a[1].cpu(), b[1])
    assert fused.stats.as_dict() == eager.stats.as_dict()
    for k in ("bit_transpose32", "run_program_cuda"):
        assert ops.LAUNCHES[k] > before.get(k, 0)


def _prog16_devices(a, b, c, **kw):
    import repro_torch.pum as pum
    from test_torch_cost_plane import prog16
    dev = pum.device(width=32, **kw)
    return dev, np.asarray(prog16(dev, a, b, c).to_numpy())


def test_shard_words_on_one_card_matches_vertical_cuda(cuda):
    """On a card, shard-words runs each shard through K1/K2 and equals
    vertical-cuda and the CPU bit for bit, with equal EngineStats."""
    rng = np.random.default_rng(22)
    ops16 = [rng.integers(0, 1 << 32, 100_000, dtype=np.uint64)
             for _ in range(3)]
    before = dict(ops.LAUNCHES)
    sdev, got = _prog16_devices(*ops16, fused_backend="shard-words")
    torch.cuda.synchronize()
    assert all(ops.LAUNCHES[k] > before.get(k, 0)
               for k in ("bit_transpose32", "run_program_cuda"))
    vdev, want = _prog16_devices(*ops16)
    hdev, host = _prog16_devices(*ops16, device="cpu")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, host)
    assert sdev.stats.as_dict() == vdev.stats.as_dict() \
        == hdev.stats.as_dict()


def test_shard_words_per_card_launches(cuda):
    """With several cards, one flush launches K1 (inputs + outputs) and K2
    (once) on every card, and equals the CPU bit for bit."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    seen = []
    real = {"t": ops.bit_transpose32_cuda, "k": ops.run_program_cuda}

    def transpose(x):
        seen.append((x.device.index, "K1"))
        return real["t"](x)

    def program(prog, x):
        seen.append((x.device.index, "K2"))
        return real["k"](prog, x)

    rng = np.random.default_rng(23)
    ops16 = [rng.integers(0, 1 << 32, 300_000 + 17, dtype=np.uint64)
             for _ in range(3)]
    ops.bit_transpose32_cuda, ops.run_program_cuda = transpose, program
    try:
        sdev, got = _prog16_devices(*ops16, fused_backend="shard-words")
    finally:
        ops.bit_transpose32_cuda, ops.run_program_cuda = real["t"], real["k"]
    hdev, host = _prog16_devices(*ops16, device="cpu")
    np.testing.assert_array_equal(got, host)
    assert sdev.stats.as_dict() == hdev.stats.as_dict()
    prog = sdev.engine.last_program
    k1 = prog.n_inputs + len(prog.outputs)
    for card in range(torch.cuda.device_count()):
        assert seen.count((card, "K1")) == k1, (card, seen)
        assert seen.count((card, "K2")) == 1, (card, seen)


def test_smoke_train_cell_on_the_card_matches_cpu(cuda, monkeypatch):
    """A train cell built by launch.steps.build_cell on one card's mesh
    equals the same cell on the CPU within 1e-5 in float32."""
    import dataclasses
    from repro_torch.config.base import ShapeConfig, get_smoke_config
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.model import init_params
    from repro_torch.models.tree import tree_map
    from repro_torch.train.optimizer import adamw_init
    cfg = dataclasses.replace(get_smoke_config("qwen3-1.7b"),
                              dtype="float32")
    monkeypatch.setattr(steps, "get_config", lambda arch: cfg)
    shape = ShapeConfig("train_tiny", "train", 16, 4)
    tokens = torch.from_numpy(np.random.default_rng(24).integers(
        0, cfg.vocab_size, (4, 17), np.int32))
    metrics = []
    for mesh, dev in ((make_test_mesh(1), cuda),
                      (make_test_mesh(devices=["cpu"]), torch.device("cpu"))):
        cell = steps.build_cell("qwen3-1.7b", shape, mesh)
        params = tree_map(lambda t: t.to(dev),
                          init_params(cfg, 0, device="cpu"))
        _, _, m = cell.fn(params, adamw_init(params),
                          {"tokens": tokens.to(dev)})
        metrics.append({k: float(v) for k, v in m.items()})
    got, want = metrics
    assert sorted(got) == sorted(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-5 * max(abs(want[k]), 1e-30), k
