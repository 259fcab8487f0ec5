"""Kernel-layer and engine microbenchmarks through the PyTorch port: the
counterpart of ``benchmarks/kernel_bench.py``, the same 21 rows in the
same order, at the same sizes and seeds, on ``device``.

The kernel rows time the port's kernels at the reference's shapes:
``kernel.maj31_oracle`` the bit-unpacking plain version
(``repro_torch.kernels.ref.maj_n``), and through the dispatch wrappers of
``repro_torch.kernels.ops`` the MAJ-N, bit-serial add, bit-transpose and
charge-sharing kernels (``csrc/*.cu`` on a CUDA card, their plain
versions on the CPU). The engine rows run the fused-pipeline staples
through the public ``repro_torch.pum`` frontend, eager (the host NumPy
``fast`` dataplane, as in the reference) against fused (on a card: the
bit-transpose and fused-program kernels), and the app rows the Fig 20
BMI and KCS kernels at paper-scale operand sizes.

Timers:

* ``kernel.*`` on a CUDA card: device microseconds of one launch. CUDA
  events bracket back-to-back calls that the host queues while the card
  runs a ``torch.cuda._sleep``, so host dispatch does not enter the span;
  the calls rotate through copies of the inputs covering at least 128 MiB
  (past the 50 MB L2), so every launch reads device memory; best of the
  reference's repeats. On the CPU: best-of-N host wall, as the reference.
* ``engine.*`` and ``app.*``: best-of-N host walls
  (``benchmarks.common.timed_us``), each call ending in a read-back
  (``to_numpy()``); ``engine.async_flush`` is the caller's submit wall.

``python -m benchmarks.torch_run --only kernel_bench [--device cpu]``
prints the rows; ``--emit-dir DIR`` writes them as
``BENCH_torch_kernel_h100.json``."""

from __future__ import annotations

import time

import numpy as np
import torch

import repro_torch.pum as pum
from benchmarks.common import Row, record_counters, row, timed_us
from repro_torch.backends import select_backend
from repro_torch.core import realworld
from repro_torch.kernels import ops, ref

W = 1 << 16  # packed words per plane = 2M bitlines
# The reference module's rows, in its order.
ROWS = ("kernel.maj31_oracle", "kernel.maj31_bitsliced",
        "kernel.bitserial_add32", "kernel.bit_transpose32",
        "kernel.charge_share32", "engine.eager_prog16", "engine.fused_prog16",
        "engine.eager_mul16", "engine.fused_mul16", "engine.eager_mul64",
        "engine.fused_mul64", "engine.sharded_prog16", "engine.async_flush",
        "engine.autotuned_prog16", "engine.autotuned_vs_static",
        "engine.leaf_cache_cold", "engine.leaf_cache_warm", "app.bmi_eager",
        "app.bmi_fused", "app.kclique_eager", "app.kclique_fused")
ROTATE_BYTES = 128 << 20   # input copies a timed round cycles through
SLEEP_CYCLES = 4_000_000   # ~2 ms of card time at least to queue calls behind
SPAN_CALLS = 256           # calls queued behind one sleep

# How each 64-bit fused backend evaluates width-64 mul/div.
ROUTES_64 = {
    "vertical-cuda-64": "the fused-program kernel over 64 bit-planes a "
                        "lane: ripple add/sub, shift-add mul and restoring "
                        "divmod, one launch a flush between bit-transposes",
    "words-torch-64": "the word-domain evaluator on (lo, hi) int32 lane "
                      "halves: carry-chained add/sub/mul and divmod on "
                      "lane pairs",
}


def _engine_prog16(dev, a, b, c):
    """16 PuM ops (the fused-pipeline staple): logicals + ripple
    adds/subs + popcount chained over three operands."""
    a = dev.asarray(a)
    t = a & b
    t = t ^ c
    t = t | b
    t = t + a
    t = t - c
    t = t ^ b
    t = t & a
    t = t + c
    t = t | a
    t = t - b
    t = t ^ a
    t = t & c
    t = t + b
    t = t.popcount()
    t = t + a
    t = t ^ c
    return t


def _engine_mulprog16(dev, a, b, c):
    """16 PuM ops centred on the fused mul/div/mod lowering (shift-add
    multiply, restoring division via the shared divmod tuple op) mixed
    with the cheaper ISA."""
    a = dev.asarray(a)
    t = a * b
    t = t + c
    t = t * a
    t = t - b
    t = t // c
    t = t ^ a
    t = t * c
    t = t | b
    t = t % a
    t = t + b
    t = t * t
    t = t & c
    t = t // b
    t = t + a
    t = t * b
    t = t ^ c
    return t


def _engine_rawprog16(dev, a, b, c):
    """16 plane-wise ops on full uint64 bitmap words: out-of-width
    operands route through the raw packed-bitmap path, the workload the
    autotuner moves onto the unsplit 64-bit plane layout."""
    a = dev.asarray(a)
    t = a & b
    t = t ^ c
    t = t | b
    t = t & c
    t = t ^ a
    t = t | c
    t = t & b
    t = t ^ c
    t = t | a
    t = t & c
    t = t ^ b
    t = t | c
    t = t & a
    t = t ^ c
    t = t | b
    t = t ^ a
    return t


def _fused_backend(device, width: int, layout: int) -> str:
    """The fused evaluator a ``device`` device selects at ``layout``."""
    return select_backend(require="fused", device=device, width=width,
                          layout=layout).name


def _eager_fused(device, width: int, **kw):
    return (pum.device(width=width, fuse=False, device=device),
            pum.device(width=width, fuse=True, device=device, **kw))


def _bench_fused_vs_eager(device, words: int) -> list[Row]:
    rng = np.random.default_rng(7)
    n = 32 * words  # one full plane set: 2M elements = 2M bitlines
    a, b, c = (rng.integers(0, 2**32, n, dtype=np.uint64) for _ in range(3))
    eager, fused = _eager_fused(device, 32)

    def run_eager():
        return _engine_prog16(eager, a, b, c).to_numpy()

    def run_fused():
        return _engine_prog16(fused, a, b, c).to_numpy()

    want = run_eager()
    got = run_fused()  # warm-up: builds the pipeline once
    ok = bool(np.array_equal(want, got)) and eager.stats == fused.stats
    us_e, _ = timed_us(run_eager, repeat=7)
    us_f, _ = timed_us(run_fused, repeat=7)
    # One traced run attaches the engine's flush/pipeline-cache counters
    # to the fused row (out of the timed loop).
    with pum.profile(fused):
        run_fused()
    record_counters("engine.fused_prog16", fused.counters)
    return [
        row("engine.eager_prog16", us_e,
            f"{16 * n / us_e:.0f} M ops*elem/s (per-op dispatch, "
            f"{n / 1e6:.0f}M lanes)"),
        row("engine.fused_prog16", us_f,
            f"{16 * n / us_f:.0f} M ops*elem/s ({us_e / us_f:.1f}x over "
            f"eager; bit_exact+stats_match={ok})"),
    ]


def _bench_mul(device, words: int, width: int, seed: int) -> tuple:
    """mulprog16 eager vs fused at ``width``: (us_e, us_f, ok, n)."""
    rng = np.random.default_rng(seed)
    n = 32 * words
    hi = 1 << min(width, 63)
    a, b, c = (rng.integers(0, hi, n, dtype=np.uint64) for _ in range(3))
    eager, fused = _eager_fused(device, width)

    def run_eager():
        return _engine_mulprog16(eager, a, b, c).to_numpy()

    def run_fused():
        return _engine_mulprog16(fused, a, b, c).to_numpy()

    want, got = run_eager(), run_fused()  # warm-up builds the pipeline
    ok = bool(np.array_equal(want, got)) and eager.stats == fused.stats
    us_e, _ = timed_us(run_eager, repeat=7)
    us_f, _ = timed_us(run_fused, repeat=7)
    return us_e, us_f, ok, n


def _bench_fused_mul(device, words: int) -> list[Row]:
    """mul/div inside the fused flush at width 16."""
    us_e, us_f, ok, n = _bench_mul(device, words, 16, 11)
    return [
        row("engine.eager_mul16", us_e,
            f"{16 * n / us_e:.0f} M ops*elem/s (per-op dispatch, "
            f"width 16)"),
        row("engine.fused_mul16", us_f,
            f"{16 * n / us_f:.0f} M ops*elem/s ({us_e / us_f:.1f}x over "
            f"eager; bit_exact+stats_match={ok})"),
    ]


def _bench_fused_mul64(device, words: int) -> list[Row]:
    """Width-64 arithmetic through the fused pipeline: the 64-bit plane
    layout routes to the device's 64-bit evaluator (``vertical-cuda-64``
    on a card, ``words-torch-64`` on the CPU)."""
    us_e, us_f, ok, n = _bench_mul(device, words, 64, 17)
    backend = _fused_backend(device, 64, 64)
    return [
        row("engine.eager_mul64", us_e,
            f"{16 * n / us_e:.0f} M ops*elem/s (per-op dispatch, "
            f"width 64)"),
        row("engine.fused_mul64", us_f,
            f"{16 * n / us_f:.0f} M ops*elem/s ({us_e / us_f:.1f}x over "
            f"eager; 64-bit plane layout via {backend} — "
            f"{ROUTES_64[backend]}; bit_exact+stats_match={ok})"),
    ]


def _bench_sharded_prog16(device, words: int) -> list[Row]:
    """The 16-op staple through the ``shard-words`` fused backend: the
    program's word axis partitions across the visible cards (one shard on
    a one-card host or on the CPU) — one flush, every card runs its slice
    of the same fused program."""
    rng = np.random.default_rng(19)
    n = 32 * words
    a, b, c = (rng.integers(0, 2**32, n, dtype=np.uint64) for _ in range(3))
    eager, sharded = _eager_fused(device, 32, fused_backend="shard-words")

    def run_eager():
        return _engine_prog16(eager, a, b, c).to_numpy()

    def run_sharded():
        return _engine_prog16(sharded, a, b, c).to_numpy()

    want, got = run_eager(), run_sharded()  # warm-up builds per shard
    ok = bool(np.array_equal(want, got)) and eager.stats == sharded.stats
    us_s, _ = timed_us(run_sharded)
    shards = (torch.cuda.device_count()
              if torch.device(device).type == "cuda" else 1)
    return [
        row("engine.sharded_prog16", us_s,
            f"{16 * n / us_s:.0f} M ops*elem/s across "
            f"{shards} device(s) (shard-words word-axis "
            f"partition; bit_exact+stats_match={ok})"),
    ]


def _bench_async_flush(device, words: int) -> list[Row]:
    """Async flush: caller-thread cost of record + ``flush_async`` submit
    vs the full synchronous flush for the same 16-op program — the
    optimize/dispatch/materialize pipeline runs on the worker, so the
    caller-visible latency is the off-thread win."""
    rng = np.random.default_rng(23)
    n = 32 * words
    a, b, c = (rng.integers(0, 2**32, n, dtype=np.uint64) for _ in range(3))
    dev = pum.device(width=32, fuse=True, device=device)
    ref_out = _engine_prog16(dev, a, b, c).to_numpy()  # warm-up build

    def run_sync():
        out = _engine_prog16(dev, a, b, c)
        dev.flush()
        return out

    us_sync, out = timed_us(run_sync, repeat=7)
    ok = bool(np.array_equal(out.to_numpy(), ref_out))

    # Caller-side submit latency, one flush in flight at a time (drain
    # between repeats so the double-buffer semaphore never backpressures
    # the timed section).
    best = float("inf")
    for _ in range(7):
        t0 = time.perf_counter()
        out = _engine_prog16(dev, a, b, c)
        h = dev.flush_async()
        best = min(best, (time.perf_counter() - t0) * 1e6)
        h.result()
        ok = ok and bool(np.array_equal(out.to_numpy(), ref_out))
    us_submit = best
    with pum.profile(dev):
        _engine_prog16(dev, a, b, c)
        dev.flush_async().result()
    record_counters("engine.async_flush", dev.counters)
    dev.close()
    return [
        row("engine.async_flush", us_submit,
            f"caller submit {us_submit:.0f}us vs {us_sync:.0f}us sync "
            f"flush ({us_sync / max(us_submit, 1e-9):.1f}x of the flush "
            f"latency moved off the caller thread; bit_exact={ok})"),
    ]


def _bench_autotuned(device, words: int) -> list[Row]:
    """Closed loop measure -> tune -> apply: profile the raw 16-op staple
    on the static width-32 default, let ``Device.autotune()`` pick a
    config from the measured counters (the raw workload rewards the
    unsplit 64-bit layout), and time the same program under the tuned
    plan. Bit-exactness and EngineStats identity are *asserted* — the
    plan may only move where/when the program runs."""
    rng = np.random.default_rng(29)
    n = 32 * words
    a, b, c = (rng.integers(0, 2**64, n, dtype=np.uint64) for _ in range(3))

    static = pum.device(width=32, fuse=True, device=device)
    tuned = pum.device(width=32, fuse=True, device=device)

    def run_static():
        return _engine_rawprog16(static, a, b, c).to_numpy()

    def run_tuned():
        return _engine_rawprog16(tuned, a, b, c).to_numpy()

    want = run_static()  # warm-up: builds the static pipeline
    with pum.profile(tuned):
        run_tuned()  # priming run: populates the counters tuning reads
    plan = tuned.autotune(apply=True)
    knobs = plan.non_default(pum.EngineConfig(width=32, fuse=True,
                                              device=device))
    assert knobs, "autotune must select a non-default config here"
    static.reset_stats()  # compare one scored run per device
    tuned.reset_stats()
    want, got = run_static(), run_tuned()
    bit_exact = bool(np.array_equal(want, got))
    stats_match = static.stats == tuned.stats
    assert bit_exact and stats_match, (bit_exact, stats_match)

    us_s, _ = timed_us(run_static, repeat=7)
    us_t, _ = timed_us(run_tuned, repeat=7)
    with pum.profile(tuned):
        run_tuned()
    record_counters("engine.autotuned_prog16", tuned.counters)
    sel = ",".join(f"{k}={v}" for k, v in sorted(knobs.items()))
    return [
        row("engine.autotuned_prog16", us_t,
            f"{16 * n / us_t:.0f} M ops*elem/s under TunedPlan({sel}; "
            f"modeled {plan.baseline_score_s / plan.score_s:.1f}x)"),
        row("engine.autotuned_vs_static", us_s,
            f"static default {us_s:.0f}us vs tuned {us_t:.0f}us host "
            f"wall ({us_s / us_t:.2f}x; the plan minimizes the modeled "
            f"PuM cost — the tuned device runs "
            f"{tuned.engine.fused_backend or 'the default backend'} at "
            f"{tuned.layout.word_bits}-bit planes, the static one "
            f"{_fused_backend(device, 32, 32)}; bit_exact=True "
            f"stats_match=True asserted)"),
    ]


def _bench_leaf_cache(device, words: int) -> list[Row]:
    """The device-resident leaf cache, cold vs warm: the same raw 16-op
    program flushed repeatedly over the same three 2M-word bitmaps. Cold
    (``leaf_cache_bytes=0``) re-stages every operand's wire snapshot per
    flush (on a card, a host-to-device copy); warm (default cache) hits
    on pointer+fingerprint and serves the device-resident buffers — the
    flush moves no leaf bytes at all. Outputs and EngineStats are
    compared (the cache is an execution detail, never a semantics
    knob)."""
    rng = np.random.default_rng(31)
    n = 32 * words
    a, b, c = (rng.integers(0, 2**64, n, dtype=np.uint64) for _ in range(3))
    cold = pum.device(width=32, fuse=True, leaf_cache_bytes=0, device=device)
    warm = pum.device(width=32, fuse=True, device=device)

    def run_cold():
        return _engine_rawprog16(cold, a, b, c).to_numpy()

    def run_warm():
        return _engine_rawprog16(warm, a, b, c).to_numpy()

    want, got = run_cold(), run_warm()  # warm-up: build + cache fill
    ok = bool(np.array_equal(want, got)) and cold.stats == warm.stats
    us_c, _ = timed_us(run_cold, repeat=7)
    us_w, _ = timed_us(run_warm, repeat=7)
    with pum.profile(warm):
        run_warm()
    record_counters("engine.leaf_cache_warm", warm.counters)
    mb = 3 * n * 8 / 1e6
    return [
        row("engine.leaf_cache_cold", us_c,
            f"leaf_cache_bytes=0: every flush re-stages ~{mb:.0f} MB of "
            f"leaf wire"),
        row("engine.leaf_cache_warm", us_w,
            f"{us_c / us_w:.2f}x vs cold (pointer+fingerprint hits serve "
            f"the device-resident leaf buffers, zero bytes staged; "
            f"bit_exact+stats_match={ok})"),
    ]


def _bench_app_kernels(device, words: int) -> list[Row]:
    """realworld packed-bitmap kernels at paper-scale operand sizes, eager
    vs fused routing (the raw planewise path): host wall time of the device
    path (the warm-up call verifies against direct NumPy once; the timed
    calls pass verify=False so the oracle is outside the timed region).
    BMI ANDs 30 x 2 MiB daily bitmaps; KCS star-extends 8192 6-cliques of
    a 2048-vertex graph through the bulk stacked-operand path — repeat
    calls reuse the memoized stacks, so fused flushes hit the leaf cache."""
    rng = np.random.default_rng(13)
    bitmaps = rng.integers(0, 2**64, (30, 4 * words), dtype=np.uint64)
    # the graph and its clique list scale with ``words`` (to at least 64)
    n = max(64, 2048 * words // W)
    adj = np.triu((rng.random((n, n)) < 0.3).astype(np.uint8), 1)
    adj = adj + adj.T
    cliques = [tuple(cl) for cl in
               rng.integers(0, n, (max(64, 8192 * words // W), 6))]

    rows: list[Row] = []
    backend = _fused_backend(device, 32, 32)
    for name, fn, args in (
            ("bmi", realworld.bmi_active_users, (bitmaps,)),
            ("kclique", realworld.kclique_star, (adj, cliques))):
        eager, fused = _eager_fused(device, 32)
        fn(fused, *args)  # warm-up: verifies + builds the fused pipeline
        fn(eager, *args)  # warm-up: verifies the eager path once too
        us_e, _ = timed_us(lambda: fn(eager, *args, verify=False))
        us_f, _ = timed_us(lambda: fn(fused, *args, verify=False))
        rows.append(row(f"app.{name}_eager", us_e, "per-op dispatch"))
        # The ratio is computed from the measured rows (never baked into
        # the string): bench_compare gates app.*_fused at >= 1.0x eager.
        rows.append(row(f"app.{name}_fused", us_f,
                        f"{us_e / us_f:.2f}x vs eager (raw planewise fused "
                        f"path: one {backend} flush per call, leaf-cache "
                        f"hits serve the device-resident bitmap uploads "
                        f"with zero bytes staged)"))
    return rows


def kernel_inputs(device, words: int = W) -> dict:
    """The kernel rows' inputs on ``device``, drawn as the reference
    draws them (seed 0): ``x32`` [31, words] and ``a``, ``b`` [32, words]
    int32 planes, ``v`` [32, words] cell voltages in {0, 1.2} and ``c``
    [32, words] capacitances ~ N(20, 1), float32."""
    rng = np.random.default_rng(0)

    def planes(rows):
        return torch.from_numpy(
            rng.integers(0, 2**32, (rows, words), dtype=np.uint64)
            .astype(np.uint32).view(np.int32)).to(device)

    x32, a, b = planes(31), planes(32), planes(32)
    v = rng.choice([0.0, 1.2], (32, words)).astype(np.float32)
    c = (20 + rng.standard_normal((32, words))).astype(np.float32)
    return {"x32": x32, "a": a, "b": b, "v": torch.from_numpy(v).to(device),
            "c": torch.from_numpy(c).to(device)}


def _maj16(x):
    return ops.maj_n(x, 16)


def _oracle16(x):
    return ref.maj_n(x, 16)


def _charge(v, c):
    return ops.charge_share(v, c, vdd=1.2, c_bl=116.0)


# Row -> (the function timed, its inputs in ``kernel_inputs``, repeats).
KERNEL_ROWS = {
    "kernel.maj31_oracle": (_oracle16, ("x32",), 1),
    "kernel.maj31_bitsliced": (_maj16, ("x32",), 3),
    "kernel.bitserial_add32": (ops.bitserial_add, ("a", "b"), 3),
    "kernel.bit_transpose32": (ops.bit_transpose32, ("a",), 3),
    "kernel.charge_share32": (_charge, ("v", "c"), 3),
}


def device_us(fn, args: tuple, repeat: int) -> float:
    """Device microseconds of one call of ``fn`` on CUDA tensors: CUDA
    events around back-to-back calls queued behind ``torch.cuda._sleep``
    (so the span holds the card's work, not the host's dispatch),
    cycling through copies of ``args`` that cover :data:`ROTATE_BYTES`;
    best of ``repeat`` rounds after one warm-up pass over the copies.

    A round is timed in spans of at most :data:`SPAN_CALLS` calls, each
    behind its own sleep (the stream's queue of launches is finite, and
    a host that waits for a slot lets the sleep run out), summed. The
    sleep outlasts the host's queueing of a span: it is at least
    :data:`SLEEP_CYCLES` and twice the warm-up's host time for a span at
    ~2 GHz, and a span whose sleep ended before its last call was queued
    (the card could have waited on the host) is run once more behind a
    sleep of four times that span's host time. A span that still waits
    (a ``fn`` of more launches than the queue holds, such as the
    unpacking oracle's ~200) is kept as it is: its time is the host's."""
    nbytes = sum(t.numel() * t.element_size() for t in args)
    copies = max(2, -(-ROTATE_BYTES // nbytes))
    sets = [args] + [tuple(t.clone() for t in args)
                     for _ in range(copies - 1)]
    spans = [sets[i:i + SPAN_CALLS] for i in range(0, copies, SPAN_CALLS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in sets:
        fn(*s)
    host_s = (time.perf_counter() - t0) * len(spans[0]) / copies
    torch.cuda.synchronize()
    sleep = max(SLEEP_CYCLES, int(4e9 * host_s))
    best = float("inf")
    for _ in range(repeat):
        ms = 0.0
        for span in spans:
            for retry in (False, True):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(sleep)
                start.record()
                t0 = time.perf_counter()
                for s in span:
                    fn(*s)
                queued_s = time.perf_counter() - t0
                end.record()
                starved = start.query()
                end.synchronize()
                if not starved or retry:
                    break
                sleep = max(sleep, int(8e9 * queued_s))
            ms += start.elapsed_time(end)
        best = min(best, ms * 1e3 / copies)
    return best


def kernel_us(device, inputs: dict) -> dict:
    """Row -> microseconds per call of each ``kernel.*`` row's function on
    ``inputs`` (:func:`device_us` on a card, host walls on the CPU)."""
    out = {}
    for name, (fn, keys, repeat) in KERNEL_ROWS.items():
        args = tuple(inputs[k] for k in keys)
        if torch.device(device).type == "cuda":
            out[name] = device_us(fn, args, repeat)
        else:
            fn(*args)
            out[name] = timed_us(fn, *args, repeat=repeat)[0]
    return out


def _kernel_rows(device, words: int) -> list[Row]:
    us = kernel_us(device, kernel_inputs(device, words))
    us0 = us["kernel.maj31_oracle"]
    maj = us["kernel.maj31_bitsliced"]
    add = us["kernel.bitserial_add32"]
    tr = us["kernel.bit_transpose32"]
    cs = us["kernel.charge_share32"]
    return [
        row("kernel.maj31_oracle", us0,
            f"{31 * words * 32 / us0 / 1e3:.1f} Gbit/s (unpack-sum "
            f"baseline)"),
        row("kernel.maj31_bitsliced", maj,
            f"{31 * words * 32 / maj / 1e3:.1f} Gbit/s ({us0 / maj:.0f}x "
            f"over oracle)"),
        row("kernel.bitserial_add32", add,
            f"{words * 32 / add:.0f} M 32-bit adds/s"),
        row("kernel.bit_transpose32", tr,
            f"{32 * words * 4 / tr / 1e3:.1f} GB/s"),
        row("kernel.charge_share32", cs,
            f"{32 * words * 8 / cs / 1e3:.1f} GB/s"),
    ]


def run(device="cuda", words: int | None = None) -> list[Row]:
    """:data:`ROWS` on ``device``; ``words`` packed words a plane
    (default :data:`W`, the reference's; tests lower it)."""
    words = W if words is None else words
    rows = _kernel_rows(device, words)
    for bench in (_bench_fused_vs_eager, _bench_fused_mul,
                  _bench_fused_mul64, _bench_sharded_prog16,
                  _bench_async_flush, _bench_autotuned, _bench_leaf_cache,
                  _bench_app_kernels):
        rows.extend(bench(device, words))
    return rows
