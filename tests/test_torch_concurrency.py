"""The port's concurrent-client dataplane against the reference, on the CPU.

The properties of ``tests/pum/test_async_flush.py`` and of the async and
capture cases of ``tests/pum/test_leaf_cache.py``, run on
``repro_torch.pum`` devices with ``device="cpu"`` and held against
``repro.pum`` wherever the reference gives values: outputs bit-exact,
``EngineStats.as_dict()`` identical (tolerance 0) —

* named client contexts, serial or interleaved in any seeded order;
* ``flush_async`` against ``flush``, double-buffered, with failed flushes
  parked for retry and the restore isolated from other clients;
* ``capture`` replays against re-recording, ``call_async``, re-recording
  per shape, closure constants uploaded once;
* the eight-thread stress at widths 8, 32 and 64;
* ``controller="auto"`` at widths 8, 32 and 64, with named clients and
  captures, and with a reliability map carried over by
  ``convert.reliability_map_from_reference`` (its bank ranking orders
  the controller's priced batch).
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

import repro.pum as rpum
import repro_torch.pum as tpum
from repro_torch import convert
from repro_torch.core import engine as tengine
from repro_torch.kernels import _build
from repro_torch.reliability import ReliabilityConfig

pytestmark = pytest.mark.fused

_BINOPS = [
    ("add", lambda x, y: x + y),
    ("and", lambda x, y: x & y),
    ("or", lambda x, y: x | y),
    ("xor", lambda x, y: x ^ y),
    ("mul", lambda x, y: x * y),
    ("sub", lambda x, y: x - y),
]


def port(**kw):
    return tpum.device(**{"fuse": True, "device": "cpu", **kw})


def ref(**kw):
    return rpum.device(**{"fuse": True, **kw})


def _mask(width):
    return np.uint64(2**width - 1) if width < 64 else np.uint64(2**64 - 1)


def random_program(rng, width, n=64, depth=4):
    """A random op chain and its NumPy reference, masked to the width."""
    mask = _mask(width)
    arrays = [rng.integers(0, int(mask), n, dtype=np.uint64, endpoint=True)
              & mask for _ in range(3)]
    picks = [int(rng.integers(len(_BINOPS))) for _ in range(depth)]
    operand = [int(rng.integers(len(arrays))) for _ in range(depth)]

    def run(asarray):
        acc = asarray(arrays[0])
        for p, i in zip(picks, operand):
            acc = _BINOPS[p][1](acc, asarray(arrays[i]))
        return acc

    want = np.asarray(run(lambda a: a), dtype=np.uint64) & mask
    return run, want


@pytest.fixture
def thread_guard():
    """Fail the test if it leaks live threads (a deadlocked worker shows
    up as a leak)."""
    before = set(threading.enumerate())
    yield
    deadline = time.monotonic() + 15.0
    while time.monotonic() < deadline:
        leaked = [t for t in threading.enumerate()
                  if t not in before and t.is_alive()]
        if not leaked:
            return
        time.sleep(0.05)
    pytest.fail(f"leaked threads: {[t.name for t in leaked]}")


# --------------------------------------------------------------------- #
# flush_async: handle semantics
# --------------------------------------------------------------------- #


def test_flush_async_result_matches_sync_and_reference(thread_guard):
    a = np.arange(256, dtype=np.uint64)
    outs, stats = [], []
    for dev, asyn in ((port(width=32), True), (port(width=32), False),
                      (ref(width=32), True)):
        with dev:
            t = (dev.asarray(a) + a) * a
            if asyn:
                h = dev.flush_async()
                assert h.exception() is None
                assert h.done()
            outs.append(t.to_numpy())
        stats.append(dev.stats.as_dict())
    want = ((2 * a) * a) & np.uint64(0xFFFFFFFF)
    for o in outs:
        np.testing.assert_array_equal(o, want)
    assert stats[0] == stats[1] == stats[2]


def test_flush_async_empty_graph_is_done_noop(thread_guard):
    with port(width=32) as dev:
        h = dev.flush_async()
        assert isinstance(h, tpum.FlushHandle)
        assert h.done() and h.result() is None


def test_flush_async_double_buffered_back_to_back(thread_guard):
    with port(width=32) as dev:
        a = np.arange(128, dtype=np.uint64)
        outs, handles = [], []
        for k in range(4):
            outs.append(dev.asarray(a) + np.uint64(k))
            handles.append(dev.flush_async())
        for h in handles:
            h.result(timeout=30)
        for k, t in enumerate(outs):
            np.testing.assert_array_equal(t.to_numpy(), a + np.uint64(k))


def test_materialize_waits_for_inflight_async(thread_guard):
    with port(width=32) as dev:
        a = np.arange(64, dtype=np.uint64)
        t = dev.asarray(a) ^ a
        dev.flush_async()
        np.testing.assert_array_equal(t.to_numpy(), np.zeros_like(a))


def test_flush_async_latency_off_caller_thread(thread_guard):
    with port(width=32) as dev:
        a = np.arange(4096, dtype=np.uint64)
        t = dev.asarray(a) * a
        h = dev.flush_async()
        deadline = time.monotonic() + 30.0
        while not h.done() and time.monotonic() < deadline:
            time.sleep(0.001)
        assert h.done()
        # already materialized by the worker: no graph left to flush
        assert t._data._value is not None
        np.testing.assert_array_equal(
            t.to_numpy(), (a * a) & np.uint64(0xFFFFFFFF))


def test_two_threads_build_one_kernel_library_once(monkeypatch):
    """A program's first flush can reach the kernel build from the caller
    and the flush worker at once: ``_build.load`` holds one lock across
    the compile, so the library is built once and both get the same
    handle."""
    calls = []

    def slow_compile(name, source):
        calls.append(name)
        time.sleep(0.2)
        return name

    class FakeLib:
        def __init__(self, path):
            self.entry = lambda *a: 0
            self.error_string = lambda rc: b""

    monkeypatch.setattr(_build, "compile_source", slow_compile)
    monkeypatch.setattr(_build.ctypes, "CDLL", FakeLib)
    monkeypatch.setattr(_build, "_LIBS", {})
    got = []
    threads = [threading.Thread(target=lambda: got.append(
        _build.load("fused_program_test", "src", "entry")))
        for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert calls == ["fused_program_test"]
    assert len(got) == 2 and got[0] is got[1]


# --------------------------------------------------------------------- #
# failure parks the graph; retry recovers
# --------------------------------------------------------------------- #


def _boom(*a, **kw):
    raise RuntimeError("transient backend failure")


def test_failed_async_flush_parks_graph_for_retry(monkeypatch,
                                                  thread_guard):
    dev = port(width=32)
    a = np.arange(64, dtype=np.uint64)
    t = dev.asarray(a) + a
    real = tengine.get_pipeline
    monkeypatch.setattr(tengine, "get_pipeline", _boom)
    h = dev.flush_async()
    with pytest.raises(RuntimeError, match="transient"):
        h.result(timeout=30)
    assert isinstance(h.exception(timeout=30), RuntimeError)
    assert dev.engine._retry and dev.engine._retry[0].state == "queued"
    monkeypatch.setattr(tengine, "get_pipeline", real)
    np.testing.assert_array_equal(t.to_numpy(), 2 * a)   # retried
    assert not dev.engine._retry
    dev.close()


def test_failed_flush_restore_is_isolated_from_other_clients(
        monkeypatch, thread_guard):
    dev = port(width=32)
    a = np.arange(64, dtype=np.uint64)
    with dev.client("A"):
        ta = dev.asarray(a) + a
    real = tengine.get_pipeline
    monkeypatch.setattr(tengine, "get_pipeline", _boom)
    with dev.client("A"):
        with pytest.raises(RuntimeError, match="transient"):
            dev.flush()
    errors = []

    def b_stream():
        try:
            with dev.client("B"):
                for k in range(20):
                    t = dev.asarray(a) ^ np.uint64(k)
                    dev.flush()
                    np.testing.assert_array_equal(t.to_numpy(),
                                                  a ^ np.uint64(k))
        except Exception as exc:                # pragma: no cover
            errors.append(exc)

    monkeypatch.setattr(tengine, "get_pipeline", real)
    th = threading.Thread(target=b_stream)
    th.start()
    np.testing.assert_array_equal(ta.to_numpy(), 2 * a)
    th.join(timeout=30)
    assert not th.is_alive() and not errors
    dev.close()


# --------------------------------------------------------------------- #
# N client streams: bit-exact + stats-identical vs serial and reference
# --------------------------------------------------------------------- #


def interleaved_run(dev, streams, rng):
    """Record the clients' programs in a seeded interleaving (each
    client's own stream FIFO), flush the clients in a seeded order."""
    n_clients = len(streams)
    remaining = [list(range(len(s))) for s in streams]
    order = []
    while any(remaining):
        ci = int(rng.integers(n_clients))
        if remaining[ci]:
            order.append((ci, remaining[ci].pop(0)))
    handles = {}
    for ci, pi in order:
        with dev.client(f"c{ci}"):
            handles[(ci, pi)] = streams[ci][pi][0](dev.asarray)
    flush_order = list(range(n_clients))
    rng.shuffle(flush_order)
    for ci in flush_order:
        with dev.client(f"c{ci}"):
            dev.flush()
    return handles


@pytest.mark.parametrize("seed", range(4))
def test_interleaved_clients_match_serial_and_reference(seed):
    rng = np.random.default_rng(seed)
    n_clients = int(rng.integers(2, 6))
    streams = [[random_program(rng, 32) for _ in range(3)]
               for _ in range(n_clients)]
    serial = port(width=32)
    serial_out = []
    for ci, progs in enumerate(streams):
        with serial.client(f"c{ci}"):
            outs = [run(serial.asarray) for run, _ in progs]
            serial.flush()
            serial_out.append([o.to_numpy() for o in outs])
    inter = port(width=32)
    got = interleaved_run(inter, streams, np.random.default_rng(seed + 100))
    reference = ref(width=32)
    want_ref = interleaved_run(reference, streams,
                               np.random.default_rng(seed + 100))
    for ci, progs in enumerate(streams):
        for pi, (_, want) in enumerate(progs):
            np.testing.assert_array_equal(got[(ci, pi)].to_numpy(), want)
            np.testing.assert_array_equal(want_ref[(ci, pi)].to_numpy(),
                                          want)
            np.testing.assert_array_equal(serial_out[ci][pi], want)
    assert inter.stats == serial.stats
    assert inter.stats.as_dict() == reference.stats.as_dict()
    assert inter.stats.latency_ns > 0
    assert sorted(inter.engine._stats_shards) == sorted(
        reference.engine._stats_shards)


def test_single_context_stats_match_reference():
    a = np.arange(512, dtype=np.uint64)
    devs = [port(width=32), port(width=32), ref(width=32)]
    for d in devs:
        ((d.asarray(a) + a) * a).to_numpy()
    assert devs[0].stats == devs[1].stats
    assert devs[0].stats.as_dict() == devs[2].stats.as_dict()
    for d in devs:
        d.close()


def test_reset_stats_clears_every_shard():
    a = np.arange(64, dtype=np.uint64)
    dev = port(width=32)
    for name in ("x", "y"):
        with dev.client(name):
            (dev.asarray(a) + a).to_numpy()
    assert len(dev.engine._stats_shards) == 2
    dev.reset_stats()
    assert dev.stats == tpum.EngineStats()


# --------------------------------------------------------------------- #
# capture: zero re-recording, cost-plane invariance
# --------------------------------------------------------------------- #


def test_capture_replays_without_rerecording_and_match_reference():
    a = np.arange(64, dtype=np.uint64)
    results = []
    for dev in (port(width=32), ref(width=32)):
        with dev:
            prog = dev.capture(lambda x, y: (x + y) * x)
            got = [prog(a + np.uint64(k), a) for k in range(5)]
            assert prog.n_records == 1 and prog.n_replays == 4
        results.append((got, dev.stats.as_dict()))
    for k, g in enumerate(results[0][0]):
        want = ((2 * a + np.uint64(k)) * (a + np.uint64(k))) \
            & np.uint64(0xFFFFFFFF)
        np.testing.assert_array_equal(g, want)
        np.testing.assert_array_equal(results[1][0][k], want)
    assert results[0][1] == results[1][1]


@pytest.mark.parametrize("width", [8, 32, 64])
def test_capture_stats_match_rerecording_and_reference(width):
    rng = np.random.default_rng(width)
    mask = _mask(width)
    a = rng.integers(0, int(mask), 128, dtype=np.uint64, endpoint=True)
    b = rng.integers(0, int(mask), 128, dtype=np.uint64, endpoint=True)

    def fn(x, y):
        return (x ^ y) + (x & y), x * y

    stats = []
    for mk in (port, ref):
        cap = mk(width=width)
        prog = cap.capture(fn)
        outs = [prog(a, b) for _ in range(3)]
        raw = mk(width=width)
        for _ in range(3):
            x, y = raw.asarray(a), raw.asarray(b)
            r = fn(x, y)
            want = [t.to_numpy() for t in r]
        for o in outs:
            for g, w in zip(o, want):
                np.testing.assert_array_equal(g, w)
        assert cap.stats == raw.stats
        stats.append(cap.stats.as_dict())
        cap.close()
        raw.close()
    assert stats[0] == stats[1]


def test_capture_new_shape_rerecords():
    with port(width=32) as dev:
        prog = dev.capture(lambda x: x + x)
        prog(np.arange(64, dtype=np.uint64))
        prog(np.arange(32, dtype=np.uint64))
        assert prog.n_records == 2
        prog(np.arange(64, dtype=np.uint64))
        assert prog.n_records == 2 and prog.n_replays == 1


def test_capture_contract_errors():
    with port(width=32, fuse=False) as dev:
        with pytest.raises(ValueError, match="fused"):
            dev.capture(lambda x: x + x)
    dev = port(width=8)
    with pytest.raises(ValueError, match="raw packed-bitmap"):
        dev.capture(lambda x: x & x)(np.full(64, 1 << 40, np.uint64))
    with pytest.raises(ValueError, match="no fused ops"):
        dev.capture(lambda x: x)(np.arange(64, dtype=np.uint64))
    prog = dev.capture(lambda x: x + x)
    prog(np.arange(64, dtype=np.uint64))
    with pytest.raises(ValueError, match="modulo 2\\*\\*8"):
        prog(np.full(64, 300, np.uint64))


def test_capture_call_async(thread_guard):
    with port(width=32) as dev:
        prog = dev.capture(lambda x: x * x)
        a = np.arange(64, dtype=np.uint64)
        h0 = prog.call_async(a)           # new shape: records, done handle
        assert h0.done()
        h1 = prog.call_async(a + np.uint64(1))
        np.testing.assert_array_equal(h0.result(), a * a)
        np.testing.assert_array_equal(
            h1.result(timeout=30),
            ((a + np.uint64(1)) ** 2) & np.uint64(0xFFFFFFFF))
        assert prog.n_records == 1 and prog.n_replays >= 1


def test_capture_constants_upload_once(monkeypatch):
    """Closure constants become device tensors at record time; replays of
    the same input buffers hit the leaf cache and upload nothing."""
    n = 4096
    a = np.arange(n, dtype=np.uint64)
    b = (a * 3) & np.uint64(0xFFFF)
    const = (a * 7) & np.uint64(0xFFFF)
    uploads = []
    real = tengine._upload
    monkeypatch.setattr(tengine, "_upload",
                        lambda w, d: uploads.append(w.size) or real(w, d))
    dev = port(width=16)
    prog = dev.capture(lambda x, y: (x + y) ^ const)
    want = ((a + b) & np.uint64(0xFFFF)) ^ const
    np.testing.assert_array_equal(prog(a, b), want)
    first = len(uploads)
    assert first == 3          # two inputs and the constant
    for _ in range(3):
        np.testing.assert_array_equal(prog(a, b), want)
    assert len(uploads) == first
    c = b.copy()               # a new buffer misses and uploads once
    np.testing.assert_array_equal(prog(a, c), want)
    assert len(uploads) == first + 1


def test_cache_hit_replays_bit_exact_across_flush_async_and_capture():
    dev = port(width=16)
    n = 50_000
    a = (np.arange(n, dtype=np.uint64) * 7) % (1 << 16)
    b = (np.arange(n, dtype=np.uint64) * 13 + 5) % (1 << 16)
    mod = np.uint64(1) << np.uint64(16)
    prog = dev.capture(lambda x, y: (x + y) * x)
    want = ((a + b) % mod * a) % mod
    np.testing.assert_array_equal(prog(a, b), want)
    for _ in range(3):
        np.testing.assert_array_equal(prog(a, b), want)
    np.testing.assert_array_equal(prog.call_async(a, b).result(), want)
    for _ in range(2):
        x = dev.asarray(a) + dev.asarray(b)
        dev.flush_async().result()
        np.testing.assert_array_equal(x.to_numpy(), (a + b) % mod)
    assert all(e.dev is not None
               for e in dev.engine._leaf_cache._entries.values())
    dev.close()


# --------------------------------------------------------------------- #
# thread stress: 8 clients on one shared device
# --------------------------------------------------------------------- #


@pytest.mark.concurrent
@pytest.mark.parametrize("width", [8, 32, 64])
def test_eight_client_thread_stress(width, thread_guard):
    dev = port(width=width)
    n_threads, n_iter = 8, 6
    errors: list = []
    barrier = threading.Barrier(n_threads)

    def worker(tid):
        try:
            rng = np.random.default_rng(1000 * width + tid)
            barrier.wait(timeout=30)
            for it in range(n_iter):
                run, want = random_program(rng, width, n=32 + 8 * tid)
                out = run(dev.asarray)
                if rng.random() < 0.5:
                    dev.flush_async().result(timeout=60)
                np.testing.assert_array_equal(out.to_numpy(), want,
                                              err_msg=f"t{tid} it{it}")
        except Exception as exc:
            errors.append((tid, exc))

    threads = [threading.Thread(target=worker, args=(i,),
                                name=f"stress-{i}")
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not [t.name for t in threads if t.is_alive()]
    assert not errors, errors[:3]
    assert dev.stats.latency_ns > 0
    dev.close()


@pytest.mark.concurrent
def test_thread_stress_stats_deterministic_and_match_reference():
    """Named clients on six threads: the merged stats do not depend on
    thread scheduling, and equal the reference's on the same streams."""
    def run_once(mk):
        dev = mk(width=32)

        def worker(tid):
            rng = np.random.default_rng(tid)
            with dev.client(f"w{tid}"):
                for _ in range(4):
                    run, want = random_program(rng, 32)
                    np.testing.assert_array_equal(
                        run(dev.asarray).to_numpy(), want)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        stats = dev.stats
        dev.close()
        return stats

    first = run_once(port)
    assert run_once(port) == first
    assert first.as_dict() == run_once(ref).as_dict()


# --------------------------------------------------------------------- #
# controller="auto": controller-priced stats identical to the reference
# --------------------------------------------------------------------- #


def ctrl_program(dev, a, b, c):
    x = dev.asarray(a)
    t = ((x + b) * x) ^ (x - c)
    return t, t < x, (t & b).popcount(), x // (c | 1)


@pytest.mark.parametrize("width", [8, 32, 64])
def test_controller_auto_matches_reference(width):
    rng = np.random.default_rng(width)
    mask = _mask(width)
    a, b, c = (rng.integers(0, int(mask), 3000, dtype=np.uint64,
                            endpoint=True) for _ in range(3))
    res = []
    for dev in (port(width=width, controller="auto"),
                ref(width=width, controller="auto")):
        outs = [t.to_numpy() for t in ctrl_program(dev, a, b, c)]
        eff = dev.engine.op_effective_ns("add")
        res.append((outs, dev.stats.as_dict(), eff))
    for g, w in zip(res[0][0], res[1][0]):
        np.testing.assert_array_equal(g, w)
    assert res[0][1] == res[1][1]
    assert res[0][1]["refresh_stall_ns"] > 0
    assert res[0][2] == res[1][2]
    plain = port(width=width)
    ctrl_program(plain, a, b, c)[0].to_numpy()
    assert plain.stats.refresh_stall_ns == 0.0


def test_controller_auto_clients_and_capture_match_reference():
    rng = np.random.default_rng(5)
    a, b = (rng.integers(0, 1 << 16, 2048, dtype=np.uint64)
            for _ in range(2))
    res = []
    for dev in (port(width=16, controller="auto", ref_postponing=4),
                ref(width=16, controller="auto", ref_postponing=4)):
        with dev.client("one"):
            t = (dev.asarray(a) * b) - a
        with dev.client("two"):
            u = (dev.asarray(b) | a) + b
        prog = dev.capture(lambda x, y: (x ^ y) * y)
        caps = [prog(a, b) for _ in range(3)]
        dev.flush()
        res.append(([t.to_numpy(), u.to_numpy()] + caps,
                    dev.stats.as_dict()))
        dev.close()
    for g, w in zip(*(r[0] for r in res)):
        np.testing.assert_array_equal(g, w)
    assert res[0][1] == res[1][1]


def test_controller_auto_with_carried_reliability_map():
    """The calibrated map's bank ranking orders the controller's priced
    batch (``ReliabilityPlane.bank_order`` -> ``batch_cost``): the stats
    equal the reference's on the same map, and differ from the same
    device without the map."""
    rdev = rpum.device(mfr="M", width=16, banks=4, fuse=True, seed=3,
                       controller="auto")
    rmap = rdev.calibrate(n_subarrays=2, n_columns=32, n_patterns=4,
                          process_variation=0.15, target_success=0.99)
    pmap = convert.reliability_map_from_reference(
        mfr=rmap.mfr, seed=rmap.seed, n_subarrays=rmap.n_subarrays,
        n_columns=rmap.n_columns, configs=rmap.configs,
        success=rmap.success, flip_p=rmap.flip_p,
        bank_scale=rmap.bank_scale)
    pdev = tpum.device(mfr="M", width=16, banks=4, seed=3, device="cpu",
                       controller="auto",
                       reliability=ReliabilityConfig(map=pmap,
                                                     target_success=0.99))
    order = pdev.engine.reliability.bank_order(4)
    assert order == rdev.engine.reliability.bank_order(4)
    assert order != sorted(order)       # the ranking is exercised
    rng = np.random.default_rng(11)
    a, b = (rng.integers(0, 1 << 16, 3000, dtype=np.uint64)
            for _ in range(2))
    outs = []
    for dev in (pdev, rdev):
        x = dev.asarray(a)
        outs.append([t.to_numpy() for t in ((x + b) * x, x & b, x < b)])
    for g, w in zip(*outs):
        np.testing.assert_array_equal(g, w)
    assert pdev.stats.as_dict() == rdev.stats.as_dict()
    batch_keys = sorted(pdev.engine._batch_cache)
    assert batch_keys == sorted(rdev.engine._batch_cache)
    for k in batch_keys:
        assert pdev.engine._batch_cache[k].__dict__ \
            == rdev.engine._batch_cache[k].__dict__
