"""The port's surface repairs against the reference, on the CPU.

Four faults kept reference tests from running through the port; each
repair is held here through both packages (the ``P`` fixture runs every
case on ``repro`` and on ``repro_torch`` with ``device="cpu"``):

* **F1** — re-registering a backend builds its pipelines anew
  (``tests/pum/test_device_and_registry.py:203-230``): the builder runs
  twice in both packages.
* **F2** — the deprecated ``PulsarEngine`` op methods
  (``tests/pum/test_device_and_registry.py:245-280``) and every case of
  ``tests/core/test_fused_pipeline.py``.
* **F3** — the leaf cache's ``__len__``/``nbytes``/``clear``: donation,
  the counters and upload span args, the LRU byte budget and the
  oversized leaf (``tests/pum/test_leaf_cache.py:136-232``).
* **F4** — ``default_db()`` answers the paper-claim and figure queries
  (``tests/test_system.py``, ``benchmarks/fig14_maj3_success.py``,
  ``benchmarks/fig15_majm_success.py``) with the reference's points.

Plus the small helpers ``PlaneLayout.popcount_shift``/``word_scalar``
and ``ref.multi_row_broadcast``. Integer results are held exactly and
``EngineStats`` compared with ``==`` (tolerance 0).
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
import types
import warnings

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ModuleNotFoundError:  # optional dep: fixed-seed fallback
    from repro.testing import given, settings, st

PACKAGES = ["repro", "repro_torch"]


def _ns(name: str) -> types.SimpleNamespace:
    ns = types.SimpleNamespace(name=name)
    ns.pum = importlib.import_module(f"{name}.pum")
    ns.core = importlib.import_module(f"{name}.core")
    ns.engine_mod = importlib.import_module(f"{name}.core.engine")
    ns.fused_program = importlib.import_module(
        f"{name}.kernels.fused_program")
    ns.alu = importlib.import_module(f"{name}.core.alu")
    ns.charact = importlib.import_module(f"{name}.core.charact")
    ns.LazyArray = ns.engine_mod.LazyArray
    ns.vec_popcount = ns.engine_mod._vec_popcount
    extra = {"device": "cpu"} if name == "repro_torch" else {}
    ns.Engine = functools.partial(ns.engine_mod.PulsarEngine, **extra)
    ns.device = lambda **kw: ns.pum.device(**{**extra, **kw})
    ns.chip_kw = extra
    return ns


NS = {name: _ns(name) for name in PACKAGES}


@pytest.fixture(params=PACKAGES)
def P(request):
    return NS[request.param]


# --------------------------------------------------------------------- #
# F1: re-registration rebuilds
# --------------------------------------------------------------------- #


def test_register_backend_is_additive_and_selectable(P):
    calls = []

    def builder(program, interpret=False, donate=False):
        calls.append(program)
        if P.name == "repro":
            return P.fused_program.build_words_pipeline(program,
                                                        donate=donate)
        return P.fused_program.build_words_pipeline(program)

    P.pum.register_backend("test-words", builder, capabilities=("fused",),
                           max_width=32, priority=99)
    try:
        dev = P.device(width=16, fuse=True)
        a = np.array([5, 6], np.uint64)
        np.testing.assert_array_equal(np.asarray(dev.asarray(a) + a), 2 * a)
        assert len(calls) == 1
        P.pum.register_backend("test-words", builder,
                               capabilities=("fused",), max_width=32,
                               priority=99)
        np.testing.assert_array_equal(np.asarray(dev.asarray(a) + a), 2 * a)
        assert len(calls) == 2  # fresh spec -> fresh build, no stale hit
    finally:
        P.pum.unregister_backend("test-words")


def test_reregistered_specs_are_unequal(P):
    b = P.pum.get_backend("ref-vertical").builder
    try:
        s1 = P.pum.register_backend("test-eq", b)
        s2 = P.pum.register_backend("test-eq", b)
        assert s1 != s2
    finally:
        P.pum.unregister_backend("test-eq")


# --------------------------------------------------------------------- #
# F2: the deprecated engine methods
# --------------------------------------------------------------------- #


def test_engine_method_surface_emits_deprecation_warnings(P):
    e = P.Engine(width=16)
    a = np.array([9, 5], np.uint64)
    b = np.array([3, 0], np.uint64)
    for name, args, want in [
            ("and_", (a, b), a & b), ("or_", (a, b), a | b),
            ("xor", (a, b), a ^ b), ("add", (a, b), a + b),
            ("sub", (a, b), a - b), ("mul", (a, b), a * b),
            ("div", (a, b), np.array([3, 0], np.uint64)),
            ("mod", (a, b), np.array([0, 0], np.uint64)),
            ("less_than", (a, b), np.zeros(2, np.uint64)),
            ("popcount", (a,), np.array([2, 2], np.uint64)),
            ("reduce_bits", (a, "or"), np.ones(2, np.uint64))]:
        with pytest.warns(DeprecationWarning, match=f"PulsarEngine.{name}"):
            got = getattr(e, name)(*args)
        np.testing.assert_array_equal(np.asarray(got, np.uint64), want,
                                      err_msg=name)
    with pytest.warns(DeprecationWarning, match="PulsarEngine.divmod"):
        q, r = e.divmod(a, np.array([2, 2], np.uint64))
    np.testing.assert_array_equal(q, a // 2)
    np.testing.assert_array_equal(r, a % 2)


def test_pum_api_does_not_warn(P):
    dev = P.device(width=16, fuse=True)
    a = np.array([9, 5], np.uint64)
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        x = dev.asarray(a)
        _ = np.asarray((x + a) * a // (x ^ 3) % (x | 1))
        _ = np.asarray(x.popcount())


# ---- tests/core/test_fused_pipeline.py through both packages -------- #

_CHAIN_OPS = ["and", "or", "xor", "add", "sub", "mul", "div", "mod"]
_TAIL_OPS = ["less", "popcount", "reduce_and", "reduce_or", "reduce_xor"]


def _rand_inputs(width, n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 1 << width, n, dtype=np.uint64)
            for _ in range(3)]


def _apply(e, name, t, other):
    if name in ("and", "or"):
        return getattr(e, name + "_")(t, other)
    if name == "less":
        return e.less_than(t, other)
    if name == "popcount":
        return e.popcount(t)
    if name.startswith("reduce_"):
        return e.reduce_bits(t, name.removeprefix("reduce_"))
    return getattr(e, name)(t, other)


def _run_sequence(e, inputs, op_seq):
    outs = []
    t = inputs[0]
    for i, name in enumerate(op_seq):
        t = _apply(e, name, t, inputs[(i + 1) % len(inputs)])
        outs.append(t)
    return [np.asarray(o, np.uint64) for o in outs]


pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")


@pytest.mark.parametrize("name", PACKAGES)
@given(width=st.sampled_from([8, 16, 32]), seed=st.integers(0, 10_000))
@settings(max_examples=6, deadline=None)
def test_fused_matches_eager_random_sequence(name, width, seed):
    P = NS[name]
    rng = np.random.default_rng(seed)
    n = int(rng.integers(33, 400))
    inputs = _rand_inputs(width, n, seed)
    n_ops = int(rng.integers(2, 7))
    op_seq = [str(rng.choice(_CHAIN_OPS)) for _ in range(n_ops - 1)]
    op_seq.append(str(rng.choice(_CHAIN_OPS + _TAIL_OPS)))
    eager = P.Engine(width=width)
    fused = P.Engine(width=width, fuse=True)
    want = _run_sequence(eager, inputs, op_seq)
    got = _run_sequence(fused, inputs, op_seq)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)
    assert eager.stats == fused.stats


def _all_opcodes(P, width):
    inputs = _rand_inputs(width, 256, seed=width)
    seq = ["and", "xor", "or", "add", "sub", "mul", "div", "mod", "less"]
    tails = ["popcount", "reduce_and", "reduce_or", "reduce_xor"]

    def run(e):
        outs = _run_sequence(e, inputs, seq)
        base = e.add(inputs[0], inputs[1])
        outs += [np.asarray(_apply(e, t, base, None), np.uint64)
                 for t in tails]
        return outs

    eager = P.Engine(width=width)
    fused = P.Engine(width=width, fuse=True)
    want, got = run(eager), run(fused)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)
    assert eager.stats == fused.stats
    return got, fused.stats


@pytest.mark.parametrize("width", [8, 16, 32])
def test_fused_all_opcodes_bit_exact(P, width):
    _all_opcodes(P, width)


@pytest.mark.parametrize("width", [8, 16, 32])
def test_fused_all_opcodes_equal_across_packages(width):
    (ro, rs), (to, ts) = (_all_opcodes(NS[n], width) for n in PACKAGES)
    for r, t in zip(ro, to):
        np.testing.assert_array_equal(r, t)
    assert rs.as_dict() == ts.as_dict()


def test_cost_plane_invariance_with_controller(P):
    inputs = _rand_inputs(32, 128, seed=3)
    seq = ["add", "xor", "sub", "and", "popcount"]
    eager = P.Engine(width=32, controller="auto")
    fused = P.Engine(width=32, controller="auto", fuse=True)
    for w, g in zip(_run_sequence(eager, inputs, seq),
                    _run_sequence(fused, inputs, seq)):
        np.testing.assert_array_equal(w, g)
    assert eager.stats == fused.stats
    assert fused.stats.refresh_stall_ns > 0


def test_charges_accrue_at_record_time(P):
    e = P.Engine(fuse=True)
    a = _rand_inputs(32, 64, seed=5)[0]
    t = e.add(a, a)
    assert e.stats.latency_ns > 0 and e.stats.n_sequences > 0
    before = dataclasses.replace(e.stats)
    _ = np.asarray(t)
    assert e.stats == before


def test_lazy_array_api_and_flush(P):
    e = P.Engine(fuse=True)
    a = _rand_inputs(32, 64, seed=7)[0]
    t = e.xor(a, a)
    assert isinstance(t, P.LazyArray)
    assert t.shape == (64,) and t.size == 64 and t.ndim == 1
    assert t.dtype == np.uint64
    assert "pending" in repr(t)
    e.flush()
    assert "materialized" in repr(t)
    np.testing.assert_array_equal(t.materialize(), np.zeros(64, np.uint64))
    e.flush()


def test_lazy_array_eq_and_bool_follow_ndarray_semantics(P):
    e = P.Engine(fuse=True)
    z = np.arange(4, dtype=np.uint64)
    t1 = e.add(z, z)
    t2 = e.add(z, z)
    np.testing.assert_array_equal(t1 == t2, np.full(4, True))
    np.testing.assert_array_equal(t1 != t2, np.full(4, False))
    with pytest.raises(ValueError):
        bool(e.add(z, z))
    one = e.add(np.ones(1, np.uint64), np.zeros(1, np.uint64))
    assert bool(one)


def test_mul_div_stay_inside_the_fused_flush(P):
    inputs = _rand_inputs(16, 96, seed=11)
    eager = P.Engine(width=16)
    fused = P.Engine(width=16, fuse=True)

    def run(e):
        t = e.add(inputs[0], inputs[2])
        m = e.mul(t, inputs[1])
        d = e.div(m, inputs[1])
        r = e.mod(m, inputs[1])
        s = e.sub(d, t)
        return (t, m, d, r, s)

    want = [np.asarray(x, np.uint64) for x in run(eager)]
    got = run(fused)
    assert all(isinstance(x, P.LazyArray) and x._value is None for x in got)
    assert fused._graph is not None and len(fused._graph.ops) == 7
    opcodes = [op for op, _, _ in fused._graph.ops]
    assert opcodes.count("divmod") == 2
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, np.asarray(g, np.uint64))
    assert eager.stats == fused.stats


@pytest.mark.parametrize("name", PACKAGES)
@given(width=st.sampled_from([8, 16, 32]), seed=st.integers(0, 10_000))
@settings(max_examples=6, deadline=None)
def test_fused_mul_div_property(name, width, seed):
    P = NS[name]
    rng = np.random.default_rng(seed)
    n = int(rng.integers(40, 300))
    a = rng.integers(0, 1 << width, n, dtype=np.uint64)
    b = rng.integers(0, 1 << width, n, dtype=np.uint64)
    edges = np.array([0, 1, 1 << (width - 1), (1 << width) - 1], np.uint64)
    a[:4], b[:4] = edges, edges[::-1]
    b[::5] = 0
    eager = P.Engine(width=width)
    fused = P.Engine(width=width, fuse=True)
    for op in ("mul", "div", "mod"):
        w = np.asarray(getattr(eager, op)(a, b), np.uint64)
        g = getattr(fused, op)(a, b)
        assert isinstance(g, P.LazyArray)
        np.testing.assert_array_equal(w, np.asarray(g, np.uint64))
    assert eager.stats == fused.stats


def test_graph_splits_on_element_count_change(P):
    e = P.Engine(fuse=True)
    a = _rand_inputs(32, 64, seed=13)[0]
    b = _rand_inputs(32, 128, seed=14)[0]
    x = e.add(a, a)
    y = e.add(b, b)
    np.testing.assert_array_equal(np.asarray(x),
                                  (a + a) & np.uint64(0xFFFFFFFF))
    np.testing.assert_array_equal(np.asarray(y),
                                  (b + b) & np.uint64(0xFFFFFFFF))


def test_dead_handles_are_dead_code(P):
    e = P.Engine(fuse=True)
    a = _rand_inputs(32, 64, seed=17)[0]
    tmp = e.and_(a, a)
    tmp = e.xor(tmp, a)
    keep = e.add(tmp, a)
    del tmp
    lat = e.stats.latency_ns
    e.flush()
    assert e.stats.latency_ns == lat
    np.testing.assert_array_equal(
        np.asarray(keep), (a + (a ^ (a & a))) & np.uint64(0xFFFFFFFF))


def test_pipeline_cache_reuses_compiled_programs(P):
    e = P.Engine(fuse=True)

    def batch(seed):
        a, b, c = _rand_inputs(32, 256, seed)
        t = e.and_(a, b)
        t = e.add(t, c)
        return np.asarray(t)

    batch(0)
    info = P.fused_program._cached_pipeline.cache_info()
    for s in range(1, 4):
        batch(s)
    after = P.fused_program._cached_pipeline.cache_info()
    assert after.currsize == info.currsize
    assert after.hits == info.hits + 3


def test_fuse_requires_fast_backend(P):
    with pytest.raises(ValueError):
        P.Engine(backend="sim", fuse=True)


def test_fused_arithmetic_rejects_out_of_width_operands(P):
    e = P.Engine(width=8, fuse=True)
    big = np.array([256, 1], np.uint64)
    one = np.array([1, 1], np.uint64)
    for op in (e.add, e.sub, e.mul, e.div, e.mod, e.less_than):
        with pytest.raises(ValueError, match="modulo"):
            op(big, one)
    np.testing.assert_array_equal(np.asarray(e.popcount(big)),
                                  np.array([1, 1], np.uint64))


def test_fused_raw_popcount_folds_lane_counts(P):
    rng = np.random.default_rng(5)
    a = rng.integers(0, 2**64, 257, dtype=np.uint64)
    b = rng.integers(0, 2**64, 257, dtype=np.uint64)
    want = P.vec_popcount(a & b)
    for fuse in (False, True):
        e = P.Engine(width=32, fuse=fuse)
        pc = e._popcount(e._and(a, b), width=64)
        composed = np.asarray(e._mul(pc, np.full_like(a, 2)), np.uint64)
        np.testing.assert_array_equal(np.asarray(pc, np.uint64), want)
        np.testing.assert_array_equal(composed, want * 2)


def test_fused_planewise_raw_bitmap_path(P):
    rng = np.random.default_rng(31)
    a = rng.integers(0, 2**64, 65, dtype=np.uint64)
    b = rng.integers(0, 2**64, 65, dtype=np.uint64)
    c = rng.integers(0, 2**64, 65, dtype=np.uint64)
    for width in (8, 32):
        eager = P.Engine(width=width)
        fused = P.Engine(width=width, fuse=True)

        def chain(e):
            t = e.and_(a, b)
            t = e.xor(t, c)
            return e.or_(t, b)

        want = np.asarray(chain(eager), np.uint64)
        got = chain(fused)
        assert isinstance(got, P.LazyArray)
        assert fused._graph is not None and fused._graph.raw
        assert len(fused._graph.ops) == 3
        np.testing.assert_array_equal(want, np.asarray(got, np.uint64))
        assert eager.stats == fused.stats


def test_raw_and_value_graphs_do_not_mix(P):
    rng = np.random.default_rng(33)
    bm = rng.integers(1 << 40, 2**64, 64, dtype=np.uint64)
    small = rng.integers(0, 256, 64, dtype=np.uint64)
    e = P.Engine(width=32, fuse=True)
    raw = e.and_(bm, bm)
    assert e._graph.raw
    t = e.add(small, small)
    assert raw._value is not None and not e._graph.raw
    np.testing.assert_array_equal(np.asarray(raw), bm)
    with pytest.raises(ValueError, match="modulo"):
        e.add(e.and_(bm, bm), small)
    np.testing.assert_array_equal(np.asarray(t), 2 * small)


def test_temporary_operands_do_not_collide(P):
    e = P.Engine(fuse=True)
    outs = []
    for k in range(8):
        tmp = np.full(64, k, np.uint64)
        outs.append(e.add(tmp, tmp))
        del tmp
    for k, o in enumerate(outs):
        np.testing.assert_array_equal(np.asarray(o),
                                      np.full(64, 2 * k, np.uint64))


def test_materialized_handles_release_the_graph(P):
    e = P.Engine(fuse=True)
    a = np.arange(64, dtype=np.uint64)
    t = e.add(a, a)
    assert any(p is a for p in e._graph._pins)
    np.testing.assert_array_equal(np.asarray(t), 2 * a)
    assert t._graph is None and t._engine is None


def test_operand_mutation_after_record_does_not_alias(P):
    e = P.Engine(fuse=True)
    b = np.arange(64, dtype=np.uint64)
    t = e.add(b, b)
    b[:] = 0
    np.testing.assert_array_equal(np.asarray(t),
                                  2 * np.arange(64, dtype=np.uint64))


def test_operand_mutation_between_uses_registers_fresh_leaf(P):
    e = P.Engine(fuse=True)
    a = np.zeros(64, dtype=np.uint64)
    t1 = e.add(a, a)
    a[:] = 5
    t2 = e.add(a, a)
    np.testing.assert_array_equal(np.asarray(t1), np.zeros(64, np.uint64))
    np.testing.assert_array_equal(np.asarray(t2),
                                  np.full(64, 10, np.uint64))


def test_flush_failure_keeps_handles_recoverable(P, monkeypatch):
    e = P.Engine(fuse=True)
    a = np.arange(64, dtype=np.uint64)
    t = e.add(a, a)

    def boom(*args, **kw):
        raise RuntimeError("transient backend failure")

    real = P.engine_mod.get_pipeline
    monkeypatch.setattr(P.engine_mod, "get_pipeline", boom)
    with pytest.raises(RuntimeError, match="transient"):
        t.materialize()
    monkeypatch.setattr(P.engine_mod, "get_pipeline", real)
    np.testing.assert_array_equal(t.materialize(), 2 * a)


def test_pending_lazy_crosses_engines_via_materialization(P):
    a = _rand_inputs(32, 64, seed=29)[0]
    e1 = P.Engine(fuse=True)
    e2 = P.Engine(fuse=True)
    t = e1.add(a, a)
    r = e2.xor(t, a)
    np.testing.assert_array_equal(
        np.asarray(r), (((a + a) & np.uint64(0xFFFFFFFF)) ^ a))


def test_cse_does_not_change_results_or_stats(P):
    rng = np.random.default_rng(41)
    a = rng.integers(0, 1 << 16, 128, dtype=np.uint64)
    b = rng.integers(0, 1 << 16, 128, dtype=np.uint64)
    eager = P.Engine(width=16)
    fused = P.Engine(width=16, fuse=True)

    def run(e):
        t1 = e.add(a, b)
        t2 = e.add(b, a)
        t3 = e.xor(t1, t2)
        t4 = e.mul(t1, t1)
        t5 = e.mul(t2, t2)
        return [np.asarray(x, np.uint64) for x in (t1, t2, t3, t4, t5)]

    for w, g in zip(run(eager), run(fused)):
        np.testing.assert_array_equal(w, g)
    assert eager.stats == fused.stats


def test_cse_normalized_programs_share_the_pipeline_cache(P):
    e = P.Engine(width=32, fuse=True)
    a, b, _ = _rand_inputs(32, 256, seed=43)
    t = e.and_(a, b)
    keep = e.add(t, a)
    np.asarray(keep)
    info = P.fused_program._cached_pipeline.cache_info()
    t = e.and_(a, b)
    dup = e.and_(a, b)
    keep = e.add(t, a)
    np.asarray(keep)
    after = P.fused_program._cached_pipeline.cache_info()
    assert after.currsize == info.currsize
    assert after.hits == info.hits + 1
    np.testing.assert_array_equal(np.asarray(dup), np.asarray(t))


def test_optimizer_prunes_dead_leaves_from_the_pipeline(P):
    e = P.Engine(width=32, fuse=True)
    a, b, c = _rand_inputs(32, 64, seed=47)
    keep = e.add(a, b)
    dead = e.xor(c, c)
    del dead
    np.testing.assert_array_equal(
        np.asarray(keep), (a + b) & np.uint64(0xFFFFFFFF))


def test_autoflush_graph_size_threshold(P):
    a, b, c = _rand_inputs(16, 64, seed=51)
    eager = P.Engine(width=16)
    fused = P.Engine(width=16, fuse=True, flush_threshold=3)

    def run(e):
        t = e.add(a, b)
        t = e.xor(t, c)
        t = e.mul(t, b)
        t = e.sub(t, a)
        t = e.or_(t, c)
        return t

    got = run(fused)
    assert fused._graph is not None and len(fused._graph.ops) == 2
    want = run(eager)
    np.testing.assert_array_equal(np.asarray(want, np.uint64),
                                  np.asarray(got, np.uint64))
    assert eager.stats == fused.stats


def test_autoflush_memory_threshold(P):
    e = P.Engine(width=32, fuse=True, flush_memory_bytes=4 * 64 * 4)
    a, b, _ = _rand_inputs(32, 64, seed=53)
    t = e.add(a, b)
    assert e._graph is not None
    t2 = e.add(t, t)
    assert e._graph is None and t2._value is not None
    np.testing.assert_array_equal(
        np.asarray(t2), (2 * ((a + b) & np.uint64(0xFFFFFFFF)))
        & np.uint64(0xFFFFFFFF))


def test_autoflush_disabled_with_none(P):
    e = P.Engine(width=16, fuse=True, flush_threshold=None,
                 flush_memory_bytes=None)
    a, b, _ = _rand_inputs(16, 64, seed=55)
    t = a
    for _ in range(64):
        t = e.add(t, b)
    assert e._graph is not None and len(e._graph.ops) == 64


@pytest.mark.parametrize("name", PACKAGES)
@given(seed=st.integers(0, 1000))
@settings(max_examples=20, deadline=None)
def test_swar_popcount_matches_scalar_oracle(name, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2**64, 257, dtype=np.uint64)
    want = np.array([bin(int(x)).count("1") for x in a], np.uint64)
    np.testing.assert_array_equal(NS[name].vec_popcount(a), want)


def test_swar_popcount_edge_values(P):
    a = np.array([0, 1, 2**63, 2**64 - 1, 0x5555555555555555], np.uint64)
    np.testing.assert_array_equal(P.vec_popcount(a),
                                  np.array([0, 1, 1, 64, 32], np.uint64))
    m = np.array([[3, 7], [15, 255]], np.uint64)
    m0 = m.copy()
    np.testing.assert_array_equal(P.vec_popcount(m),
                                  np.array([[2, 3], [4, 8]], np.uint64))
    np.testing.assert_array_equal(m, m0)


def test_engine_popcount_small_arrays_use_swar(P):
    e = P.Engine(width=32)
    rng = np.random.default_rng(23)
    for n in (1, 31, 33, 4095, 5000):
        a = rng.integers(0, 2**32, n, dtype=np.uint64)
        want = np.array([bin(int(x)).count("1") for x in a], np.uint64)
        np.testing.assert_array_equal(np.asarray(e.popcount(a)), want)


# --------------------------------------------------------------------- #
# F3: the leaf cache's size surface
# --------------------------------------------------------------------- #


def test_donation_never_serves_cached_device_buffers(P, monkeypatch):
    if P.name == "repro":  # pin the reference's jitted evaluator
        monkeypatch.setattr(P.fused_program, "_NP_CUTOFF_WIRE_OPS", 1 << 10)
    rng = np.random.default_rng(9)
    a = rng.integers(0, 2**64, 65536, dtype=np.uint64)
    b = rng.integers(0, 2**64, 65536, dtype=np.uint64)

    def prog(dev):
        x = dev.asarray(a)
        t = (x & b) | (x ^ b)
        t = (t & b) ^ x
        return t.to_numpy()

    don = P.device(width=32, fuse=True, donate_leaves=True)
    plain = P.device(width=32, fuse=True)
    cold = [prog(d) for d in (don, plain)]
    warm = [prog(d) for d in (don, plain)]
    np.testing.assert_array_equal(cold[0], cold[1])
    np.testing.assert_array_equal(warm[0], warm[1])
    np.testing.assert_array_equal(cold[0], warm[0])
    assert don.stats == plain.stats
    dcache = don.engine._leaf_cache
    assert len(dcache) > 0
    assert all(e.dev is None for e in dcache._entries.values())
    pcache = plain.engine._leaf_cache
    assert any(e.dev is not None for e in pcache._entries.values())
    don.close()
    plain.close()


def test_leaf_cache_counters_and_leaf_upload_span_args(P):
    dev = P.device(width=32, fuse=True)
    rng = np.random.default_rng(3)
    a = rng.integers(0, 2**64, 8192, dtype=np.uint64)
    b = rng.integers(0, 2**64, 8192, dtype=np.uint64)
    with P.pum.profile(dev) as tr:
        (dev.asarray(a) & b).to_numpy()  # cold: stages + inserts
        (dev.asarray(a) & b).to_numpy()  # warm: pointer+fp hits
    assert dev.counters["engine.leaf_cache.misses"] >= 2
    assert dev.counters["engine.leaf_cache.hits"] >= 2
    assert dev.counters["engine.leaf_bytes_staged"] > 0
    assert dev.counters["engine.snapshot_bytes_elided"] > 0
    ups = [args for (name, _, _, args) in tr.events
           if name == "flush.leaf_upload"]
    assert len(ups) >= 2
    assert all("bytes_staged" in u and "bytes_skipped" in u for u in ups)
    assert any(u["bytes_skipped"] > 0 for u in ups)
    dev.close()


def test_untraced_flushes_record_no_counters(P):
    dev = P.device(width=32, fuse=True)
    a = np.arange(1024, dtype=np.uint64)
    for _ in range(2):
        (dev.asarray(a) + 1).to_numpy()
    assert dev.counters.get("engine.leaf_cache.hits") == 0
    assert dev.counters.get("engine.leaf_bytes_staged") == 0
    dev.close()


def test_lru_eviction_respects_byte_budget(P):
    dev = P.device(width=32, fuse=True, leaf_cache_bytes=8192)
    cache = dev.engine._leaf_cache
    arrs = [np.arange(512, dtype=np.uint64) + i for i in range(6)]
    with P.pum.profile(dev):
        for a in arrs:
            (dev.asarray(a) + 1).to_numpy()
    assert dev.counters["engine.leaf_cache.evictions"] >= 1
    assert cache.nbytes <= 8192
    assert 1 <= len(cache) <= 4
    dev.close()


def test_oversized_leaf_is_not_cached(P):
    dev = P.device(width=32, fuse=True, leaf_cache_bytes=1024)
    a = np.arange(4096, dtype=np.uint64)
    r = (dev.asarray(a) + 1).to_numpy()
    np.testing.assert_array_equal(r, a + 1)
    assert len(dev.engine._leaf_cache) == 0
    dev.close()


def test_leaf_cache_clear_empties_the_budget(P):
    dev = P.device(width=32, fuse=True)
    cache = dev.engine._leaf_cache
    a = np.arange(512, dtype=np.uint64)
    (dev.asarray(a) + 1).to_numpy()
    assert len(cache) == 1 and cache.nbytes == 2048
    cache.clear()
    assert len(cache) == 0 and cache.nbytes == 0
    np.testing.assert_array_equal((dev.asarray(a) + 1).to_numpy(), a + 1)
    dev.close()


def test_leaf_cache_sizes_equal_across_packages():
    sizes = []
    for name in PACKAGES:
        dev = NS[name].device(width=32, fuse=True, leaf_cache_bytes=8192)
        # Kept alive: the cache is keyed on the caller's buffer, and a
        # freed temporary's address may be reused by the next one.
        arrs = [np.arange(512, dtype=np.uint64) + i for i in range(6)]
        for a in arrs:
            (dev.asarray(a) + 1).to_numpy()
        sizes.append((len(dev.engine._leaf_cache),
                      dev.engine._leaf_cache.nbytes))
        dev.close()
    assert sizes[0] == sizes[1]


# --------------------------------------------------------------------- #
# F4: success points for the paper's claims (tests/test_system.py)
# --------------------------------------------------------------------- #


def test_public_api_surface(P):
    for name in P.core.__all__:
        assert hasattr(P.core, name), name


def test_paper_headline_claims_hold_in_sim(P):
    c = P.core
    geom = c.DramGeometry(row_bits=256, rows_per_subarray=512,
                          subarrays_per_bank=2, banks=1)
    for profile, max_rows in ((c.MFR_H, 32), (c.MFR_M, 16)):
        chip = c.PulsarChip(geom, profile, seed=0, **P.chip_kw)
        chip.decoder = chip.decoder.__class__(geom, profile, None)
        x = c.PulsarExecutor(chip, 0, 0)
        assert x.max_n_rg() == max_rows
    db = P.charact.default_db()
    assert db.mean("H", 3, 32) > db.mean("H", 3, 4) + 0.1
    pulsar = P.Engine(mfr="M", use_pulsar=True)
    frac = P.Engine(mfr="M", use_pulsar=False)
    for kind, planes in (("reduce_and", 64), ("reduce_xor", 64),
                         ("add", None), ("mul", None), ("div", None)):
        _, _, sr_p, c_p = pulsar._cfg_for(kind, 32, planes)
        _, _, sr_f, c_f = frac._cfg_for(kind, 32, planes)
        assert c_p.latency_ns / sr_p <= c_f.latency_ns / sr_f * 1.0001, kind


def test_full_stack_compute_pipeline(P):
    c = P.core
    geom = c.DramGeometry(row_bits=128, rows_per_subarray=256,
                          subarrays_per_bank=1, banks=1,
                          predecoder_widths=(2, 2, 2, 2))
    chip = c.PulsarChip(geom, c.MFR_H, seed=0, **P.chip_kw)
    chip.decoder = chip.decoder.__class__(geom, c.MFR_H, None)
    alu = P.alu.BitSerialAlu(c.PulsarExecutor(chip, 0, 0), width=8)
    rng = np.random.default_rng(0)
    a = rng.integers(0, 100, 128, dtype=np.uint64)
    b = rng.integers(1, 100, 128, dtype=np.uint64)
    va, vb = alu.load(a), alu.load(b)
    s = alu.add(va, vb)
    m = alu.mul(va, vb)
    np.testing.assert_array_equal(alu.store(s), (a + b) & 0xFF)
    np.testing.assert_array_equal(alu.store(m), (a * b) & 0xFF)
    assert chip.stats.latency_ns > 0
    assert chip.stats.energy_j > 0
    assert chip.stats.n_acts > 100


def test_full_stack_stats_equal_across_packages():
    stats = []
    for name in PACKAGES:
        c = NS[name].core
        geom = c.DramGeometry(row_bits=128, rows_per_subarray=256,
                              subarrays_per_bank=1, banks=1,
                              predecoder_widths=(2, 2, 2, 2))
        chip = c.PulsarChip(geom, c.MFR_H, seed=0, **NS[name].chip_kw)
        chip.decoder = chip.decoder.__class__(geom, c.MFR_H, None)
        alu = NS[name].alu.BitSerialAlu(c.PulsarExecutor(chip, 0, 0),
                                        width=8)
        rng = np.random.default_rng(0)
        va = alu.load(rng.integers(0, 100, 128, dtype=np.uint64))
        vb = alu.load(rng.integers(1, 100, 128, dtype=np.uint64))
        alu.store(alu.mul(va, vb))
        stats.append((chip.stats.latency_ns, chip.stats.energy_j,
                      chip.stats.n_acts))
    assert stats[0] == stats[1]


@pytest.mark.parametrize("mfr", ["H", "M"])
def test_figure_points_equal_reference(mfr):
    """Fig 14 (MAJ3 vs N_RG) and Fig 15 (MAJ-m vs N_RG), queried as the
    benchmarks query them (``max`` plans): the port's table gives the
    reference ``default_db()``'s points exactly."""
    rdb = NS["repro"].charact.default_db()
    tdb = NS["repro_torch"].charact.default_db()
    pts = NS["repro_torch"].charact.figure_points(mfr)
    assert (3, 4, "max") in pts and (3, 16, "max") in pts
    for m, n, style in pts:
        want = dataclasses.asdict(rdb.point(mfr, m, n, plan_style=style))
        got = dataclasses.asdict(tdb.point(mfr, m, n, plan_style=style))
        assert got == want, (mfr, m, n)


# --------------------------------------------------------------------- #
# 13d: small helpers
# --------------------------------------------------------------------- #


def test_layout_popcount_shift_and_word_scalar():
    from repro.kernels.plane_layout import LAYOUT32 as R32, LAYOUT64 as R64
    from repro_torch.kernels.plane_layout import get_layout
    T32, T64 = get_layout(32), get_layout(64)
    assert (T32.popcount_shift, T64.popcount_shift) == (24, 56)
    assert (T32.popcount_shift, T64.popcount_shift) \
        == (R32.popcount_shift, R64.popcount_shift)
    for tl, rl in ((T32, R32), (T64, R64)):
        v = tl.mask(tl.word_bits)
        assert tl.word_scalar(v, np) == rl.word_scalar(v, np)
        assert tl.word_scalar(v, np).dtype == rl.word_scalar(v, np).dtype
        t = tl.word_scalar(v, torch)
        assert t.dtype == getattr(torch, tl.dtype_name) and t.ndim == 0
        assert int(t.to(torch.int64) & ((1 << 63) - 1)) == v & ((1 << 63) - 1)


def test_multi_row_broadcast_matches_reference():
    import jax.numpy as jnp
    from repro.kernels import ref as rref
    from repro_torch.kernels import ref as tref
    rng = np.random.default_rng(61)
    src = rng.integers(-2**31, 2**31, 37, dtype=np.int64).astype(np.int32)
    for n in (1, 4, 32):
        want = np.asarray(rref.multi_row_broadcast(jnp.asarray(src), n))
        got = tref.multi_row_broadcast(torch.from_numpy(src), n)
        assert tuple(got.shape) == (n, 37)
        np.testing.assert_array_equal(got.numpy(), want)
