"""Port engine (record + fused flush on the CPU) vs the reference engine.

Every case runs the same seeded operands through ``repro.pum`` (fused and
eager) and ``repro_torch.pum`` with ``device="cpu"``: outputs are
bit-exact and ``EngineStats`` identical. The ``sim`` backend (the chip
model's bit-serial ALU) is held the same way, with the chip's ``OpStats``
and the ALU's ``op_counts`` equal too.
"""

from __future__ import annotations

import operator

import numpy as np
import pytest
import torch

import repro.pum as rpum
import repro_torch.pum as tpum
from repro_torch.kernels import fused_program as tfp
from test_torch_cost_plane import mulprog16, prog16


def _ops(width, n, seed):
    rng = np.random.default_rng(seed)
    if width == 64:
        return [rng.integers(0, 2**64 - 1, n, dtype=np.uint64,
                             endpoint=True) for _ in range(3)]
    return [rng.integers(0, 1 << width, n, dtype=np.uint64)
            for _ in range(3)]


def _check(fn, width, operands, **port_kw):
    rf = rpum.device(width=width, fuse=True)
    re_ = rpum.device(width=width, fuse=False)
    want = fn(rf, *operands).to_numpy()
    np.testing.assert_array_equal(fn(re_, *operands).to_numpy(), want)
    td = tpum.device(width=width, device="cpu", **port_kw)
    got = fn(td, *operands).to_numpy()
    np.testing.assert_array_equal(got, want)
    assert td.stats.as_dict() == rf.stats.as_dict() == re_.stats.as_dict()
    return td


@pytest.mark.parametrize("fn,width", [(prog16, 32), (mulprog16, 16),
                                      (mulprog16, 64), (prog16, 64)])
def test_fused_flush_matches_reference(fn, width):
    a, b, c = _ops(width, 1000, width)
    b[::7] = 0  # zero divisors reach the dividers of mulprog16
    td = _check(fn, width, (a, b, c))
    assert td.engine.fuse


@pytest.mark.parametrize("backend", ["ref-vertical", "vertical-cuda"])
def test_vertical_backends_by_name(backend):
    """The plain versions of both kernels (``ref-vertical``), and the
    kernel wrappers' CPU dispatch, run through the engine."""
    a, b, c = _ops(32, 500, 3)
    _check(prog16, 32, (a, b, c), fused_backend=backend)
    a, b, c = _ops(64, 200, 4)
    _check(mulprog16, 64, (a, b, c), fused_backend=f"{backend}-64")


def _bitmap_prog(dev, words):
    acc = dev.asarray(words[0])
    for w in words[1:4]:
        acc = acc & w
    hits = acc | words[4]
    flips = hits ^ words[5]
    return [acc.popcount(), hits, flips.popcount(), flips]


@pytest.mark.parametrize("width", [8, 32, 64])
def test_raw_bitmap_mode_matches_reference(width):
    """Plane-wise ops on out-of-width uint64 words: the raw packed-bitmap
    graph (two 32-bit lanes per word on the 32-bit layout) and the
    popcount's two-lane fold at materialization."""
    rng = np.random.default_rng(width)
    words = [rng.integers(0, 2**64 - 1, 333, dtype=np.uint64,
                          endpoint=True) for _ in range(6)]
    rdev = rpum.device(width=width)
    tdev = tpum.device(width=width, device="cpu")
    edev = rpum.device(width=width, fuse=False)
    want = [x.to_numpy() for x in _bitmap_prog(rdev, words)]
    got = [x.to_numpy() for x in _bitmap_prog(tdev, words)]
    eager = [x.to_numpy() for x in _bitmap_prog(edev, words)]
    for g, w, e in zip(got, want, eager, strict=True):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, e)
    assert tdev.stats.as_dict() == rdev.stats.as_dict()


def test_autoflush_threshold_matches_reference():
    a, b, c = _ops(32, 640, 9)
    rdev = rpum.device(width=32, flush_threshold=3)
    tdev = tpum.device(width=32, device="cpu", flush_threshold=3)
    want = prog16(rdev, a, b, c).to_numpy()
    with tpum.profile(tdev):
        got = prog16(tdev, a, b, c).to_numpy()
    np.testing.assert_array_equal(got, want)
    assert tdev.stats.as_dict() == rdev.stats.as_dict()
    assert tdev.counters.get("engine.autoflush.ops") == 5  # 16 ops / 3
    assert tdev.counters.get("engine.flushes") == 6


@pytest.mark.parametrize("cache_bytes,donate", [(1 << 26, False),
                                                (0, False),
                                                (1 << 26, True)])
def test_leaf_cache_and_donation(cache_bytes, donate):
    a, b, c = _ops(32, 4096, 11)
    want = prog16(rpum.device(width=32), a, b, c).to_numpy()
    tdev = tpum.device(width=32, device="cpu", leaf_cache_bytes=cache_bytes,
                       donate_leaves=donate)
    with tpum.profile(tdev):
        for _ in range(3):
            np.testing.assert_array_equal(
                prog16(tdev, a, b, c).to_numpy(), want)
    hits = tdev.counters.get("engine.leaf_cache.hits")
    cache = tdev.engine._leaf_cache
    if cache_bytes:
        assert hits == 6  # flushes 2 and 3 hit all three leaves
        kept = [e.dev is not None for e in cache._entries.values()]
        # A donating flush keeps no uploaded leaf; otherwise the device
        # tensors stay cached across flushes.
        assert not any(kept) if donate else all(kept)
    else:
        assert hits == 0 and cache is None


def test_tracer_spans_and_pipeline_cache():
    a, b, c = _ops(32, 256, 12)
    tdev = tpum.device(width=32, device="cpu")
    with tpum.profile(tdev) as tr:
        prog16(tdev, a, b, c).to_numpy()
        prog16(tdev, a, b, c).to_numpy()
    names = tr.span_names()
    for span in ("flush.record", "flush.optimize", "flush.leaf_upload",
                 "flush.compile", "flush.dispatch", "flush.materialize"):
        assert names.count(span) == 2, span
    assert tdev.counters.get("engine.pipeline_cache.hit") >= 1
    assert tdev.counters.get("engine.ops_recorded") == 32


def test_lazy_semantics_match_reference():
    """divmod/compare operators, scalars, slicing and a dead handle."""
    a, b, _ = _ops(16, 100, 13)
    b[:10] = 0

    def body(dev):
        x = dev.asarray(a)
        q, r = divmod(x, b)
        _dead = x * 3  # noqa: F841 (charged, never materialized)
        le = x <= b
        ge = (x + 7) >= b
        return [q, r, le, ge, (x % 5)[3:9], x // b, x.reduce_bits("and"),
                x.reduce_bits("or"), x.reduce_bits("xor", width=8)]

    rdev = rpum.device(width=16)
    tdev = tpum.device(width=16, device="cpu")
    want = [v.to_numpy() for v in body(rdev)]
    got = [v.to_numpy() for v in body(tdev)]
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)
    assert tdev.stats.as_dict() == rdev.stats.as_dict()


def test_out_of_width_arithmetic_is_refused():
    tdev = tpum.device(width=8, device="cpu")
    with pytest.raises(ValueError, match="modulo 2\\*\\*8"):
        (tdev.asarray(np.array([300], np.uint64)) + 1).to_numpy()


def test_selection_follows_the_device():
    from repro_torch.backends import select_backend
    assert select_backend(require="fused", device="cpu",
                          width=32, layout=32).name == "words-torch"
    assert select_backend(require="fused", device="cuda",
                          width=32, layout=32).name == "vertical-cuda"
    assert select_backend(require="fused", device="cuda",
                          width=64, layout=64).name == "vertical-cuda-64"
    # A pinned fused backend resolves by name on any device.
    prog = tfp.FusedProgram(8, 1, (tfp.FusedOp("popcount", (0,)),), (1,))
    pipe = tfp.get_pipeline(prog, device="cpu", backend="ref-vertical")
    out = pipe(torch.arange(32, dtype=torch.int32))[0]
    assert out.tolist() == [bin(i).count("1") for i in range(32)]


def test_default_device_is_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        tpum.device()
    with pytest.raises(RuntimeError, match="cuda"):
        tpum.device(width=8, fuse=False)
    assert tpum.EngineConfig().device == "cuda"


def test_later_slices_raise_naming_them():
    # The controller slice is ported: controller="auto" builds the port's
    # MemoryController and prices through it.
    from repro_torch.controller import MemoryController
    dev = tpum.device(device="cpu", controller="auto", ref_postponing=2)
    assert isinstance(dev.engine.controller, MemoryController)
    assert dev.engine.controller.postponing == 2
    # The reliability slice is ported: reliability= validates its input
    # as the reference does.
    with pytest.raises(TypeError, match="ReliabilityConfig"):
        tpum.device(device="cpu", reliability=object())
    # The chip-model slice is ported: backend="sim" builds (eager, per op).
    assert not tpum.device(device="cpu", backend="sim").config.fuse
    # The distributed slice is ported: shard-words builds and is the
    # flush's evaluator (its results are held in
    # tests/test_torch_shard_words.py).
    sdev = tpum.device(device="cpu", fused_backend="shard-words")
    assert sdev.engine.fused_backend == "shard-words"
    sx = sdev.asarray(np.arange(64, dtype=np.uint64))
    assert (sx + sx).to_numpy().tolist() == [2 * i for i in range(64)]
    assert sdev.engine.last_program is not None
    # The concurrency slice is ported: flush_async, capture and client
    # build (their behaviour is held in tests/test_torch_concurrency.py).
    dev = tpum.device(device="cpu")
    assert isinstance(dev.flush_async(), tpum.FlushHandle)
    assert isinstance(dev.capture(lambda x: x + x), tpum.CapturedProgram)
    with dev.client("a") as eng:
        assert eng is dev.engine
    dev.close()
    # The autotune slice is ported: a device profiled under no tracer has
    # no counter window to tune from, and says how to measure one.
    with pytest.raises(ValueError, match="pum.profile"):
        dev.autotune()


SIM_OPS = {"+": operator.add, "-": operator.sub, "*": operator.mul,
           "//": operator.floordiv, "%": operator.mod, "&": operator.and_,
           "|": operator.or_, "^": operator.xor}
# Per width, the ops of the sim device in order. The ALU allocates from one
# 512-row subarray: in the reference a 32-bit divider and a 64-bit
# multiplier run out of rows and raise; the port raises at the same chip
# command (SIM_RAISES).
SIM_CASES = {8: "+ - * // % & | ^ divmod", 16: "+ - * // % & | ^",
             32: "+ - & | ^ //", 64: "+ - & | ^ *"}
SIM_RAISES = {(32, "//"), (64, "*")}


@pytest.mark.parametrize("width", sorted(SIM_CASES))
def test_sim_backend_matches_reference(width):
    """``pum.device(backend="sim")``: eager, per op on the chip model, with
    zero-divisor lanes yielding 0 (the engine-wide contract)."""
    import dataclasses
    devs = [rpum.device(mfr="H", width=width, backend="sim", row_bits=256),
            tpum.device(mfr="H", width=width, backend="sim", row_bits=256,
                        device="cpu")]
    assert not devs[1].config.fuse
    n = devs[1].engine._alu.words * 32
    a, b = _ops(width, n, width)[:2]
    b[::5] = 0
    for op in SIM_CASES[width].split():
        outs = []
        for d in devs:
            x = d.asarray(a)
            if (width, op) in SIM_RAISES:
                with pytest.raises(RuntimeError, match="out of rows"):
                    np.asarray(SIM_OPS[op](x, b))
                continue
            if op == "divmod":
                q, r = divmod(x, b)
                outs.append(np.stack([np.asarray(q), np.asarray(r)]))
            else:
                outs.append(np.asarray(SIM_OPS[op](x, b)))
        if outs:
            np.testing.assert_array_equal(outs[1], outs[0])
            if op in ("//", "%"):
                want = np.where(b == 0, 0,
                                SIM_OPS[op](a, np.maximum(b, 1)))
                np.testing.assert_array_equal(outs[1], want)
    assert devs[1].stats.as_dict() == devs[0].stats.as_dict()
    rchip, tchip = (d.engine._alu.chip for d in devs)
    assert dataclasses.asdict(tchip.stats) == dataclasses.asdict(rchip.stats)
    assert devs[1].engine._alu.op_counts == devs[0].engine._alu.op_counts
    np.testing.assert_array_equal(tchip.banks.numpy().view(np.uint32),
                                  rchip.banks)


def test_sim_engine_refuses_fuse_and_keeps_large_operands_on_the_host():
    from repro_torch.core.engine import PulsarEngine
    with pytest.raises(ValueError, match="routes ops through an ALU"):
        PulsarEngine(backend="sim", fuse=True, device="cpu")
    # An operand larger than one chip row is computed by the host NumPy
    # dataplane, as in the reference.
    dev = tpum.device(mfr="H", width=8, backend="sim", row_bits=64,
                      device="cpu")
    chip = dev.engine._alu.chip
    a = np.arange(200, dtype=np.uint64) % 256
    ops_before = chip.stats.n_ops
    np.testing.assert_array_equal(np.asarray(dev.asarray(a) + a),
                                  (a + a) & np.uint64(0xFF))
    assert chip.stats.n_ops == ops_before
