"""``benchmarks/torch_kernel_bench.py`` held against the reference's
``benchmarks/kernel_bench.py`` on the CPU, at a lowered size: the three
programs' outputs and ``EngineStats`` through both packages, eager and
fused; the telemetry counters of the four rows that record them; the
autotuned plan for the raw program under the reference's anchors; the
rows' names, order and booleans, and their ``derived`` words where the
port keeps the reference's; and ``chip_smoke.kernel_bench`` rehearsed.
No timing is asserted."""

from __future__ import annotations

import json
import pathlib
import re
import sys

import numpy as np
import pytest

import repro.pum as rpum
import repro_torch.pum as tpum
from repro_torch import convert
from repro_torch.autotune import cost

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import common, torch_run  # noqa: E402
from benchmarks import kernel_bench as rkb  # noqa: E402
from benchmarks import torch_kernel_bench as tkb  # noqa: E402

WORDS = 8          # packed words a plane: 256 lanes
FLAG = re.compile(r"(?:bit_exact|stats_match)\S*=(\w+)")
# Rows whose words name the port's own route (or drop the reference's
# pointers into its notes); every other row keeps the reference's words.
OWN_WORDS = {"kernel.maj31_bitsliced", "engine.fused_prog16",
             "engine.fused_mul64", "engine.autotuned_vs_static",
             "app.bmi_fused", "app.kclique_fused"}
COUNTER_ROWS = ("engine.fused_prog16", "engine.async_flush",
                "engine.autotuned_prog16", "engine.leaf_cache_warm")


@pytest.fixture(scope="module")
def runs():
    """Both modules' rows and recorded counters at ``WORDS`` words a
    plane (the reference's ``W`` lowered for the call)."""
    real_w = rkb.W
    rkb.W = WORDS
    try:
        ref = rkb.run()
    finally:
        rkb.W = real_w
    ref_counters = common.drain_counters()
    port = tkb.run(device="cpu", words=WORDS)
    port_counters = common.drain_counters()
    return {"ref": ref, "port": port, "ref_counters": ref_counters,
            "port_counters": port_counters}


def _operands(width: int, n: int, seed: int):
    rng = np.random.default_rng(seed)
    hi = 2**64 if width == 64 else 1 << width
    return [rng.integers(0, hi, n, dtype=np.uint64) for _ in range(3)]


PROGRAMS = [("_engine_prog16", 32), ("_engine_mulprog16", 16),
            ("_engine_mulprog16", 64), ("_engine_rawprog16", 32)]


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("name,width", PROGRAMS)
def test_program_outputs_and_stats_equal_the_reference(name, width, fuse):
    n = 32 * WORDS
    a, b, c = _operands(64 if name == "_engine_rawprog16" else
                        min(width, 63), n, seed=width)
    rdev = rpum.device(width=width, fuse=fuse)
    tdev = tpum.device(width=width, fuse=fuse, device="cpu")
    want = getattr(rkb, name)(rdev, a, b, c).to_numpy()
    got = getattr(tkb, name)(tdev, a, b, c).to_numpy()
    assert got.dtype == want.dtype == np.uint64
    np.testing.assert_array_equal(got, want)
    r, t = rdev.stats.as_dict(), tdev.stats.as_dict()
    assert list(t) == list(r)
    for field in r:
        assert t[field] == r[field], field


def test_row_names_in_the_reference_order(runs):
    names = [n for n, _, _ in runs["port"]]
    assert names == [n for n, _, _ in runs["ref"]] == list(tkb.ROWS)
    baseline = json.loads((ROOT / "BENCH_kernel.json").read_text())
    assert set(names) == set(baseline["rows"])


def test_every_flag_true(runs):
    flags = [f for _, _, d in runs["port"] for f in FLAG.findall(d)]
    assert len(flags) == 8 and set(flags) == {"True"}
    assert all(us > 0 for _, us, _ in runs["port"])


@pytest.mark.parametrize("row", [r for r in tkb.ROWS if r not in OWN_WORDS])
def test_derived_words_are_the_reference_words(runs, row):
    """The same template (numbers aside), the backend names of a tuned
    plan mapped (``words-torch-64`` is the port's ``words-cpu-64``)."""
    ref = dict((n, d) for n, _, d in runs["ref"])[row]
    port = dict((n, d) for n, _, d in runs["port"])[row]
    assert torch_run.split(port.replace("words-torch", "words-cpu"))[0] \
        == torch_run.split(ref)[0]


@pytest.mark.parametrize("row", [r for r in tkb.ROWS if r in OWN_WORDS])
def test_own_words_name_the_port_route(runs, row):
    port = dict((n, d) for n, _, d in runs["port"])[row]
    assert "§Perf" not in port and "jitted" not in port
    assert "words-cpu" not in port and "XLA" not in port
    if row.startswith("app.") or row == "engine.fused_mul64":
        assert "words-torch" in port


@pytest.mark.parametrize("row", COUNTER_ROWS)
def test_counter_rows_equal_the_reference(runs, row):
    assert set(runs["port_counters"]) == set(COUNTER_ROWS)
    assert set(runs["ref_counters"]) == set(COUNTER_ROWS)
    assert runs["port_counters"][row] == runs["ref_counters"][row]


def _tune_rawprog16(pm, rkw: dict, words: int):
    """The autotuned row's flow up to the plan: a static warm-up, one
    profiled priming run on the tuned device, ``autotune``."""
    rng = np.random.default_rng(29)
    a, b, c = (rng.integers(0, 2**64, 32 * words, dtype=np.uint64)
               for _ in range(3))
    static = pm.device(width=32, fuse=True, **rkw)
    tuned = pm.device(width=32, fuse=True, **rkw)
    program = (tkb if pm is tpum else rkb)._engine_rawprog16
    program(static, a, b, c).to_numpy()
    with pm.profile(tuned):
        program(tuned, a, b, c).to_numpy()
    return tuned.autotune(apply=True), pm.EngineConfig(width=32, fuse=True,
                                                       **rkw)


@pytest.mark.parametrize("words", [1, WORDS])
def test_autotuned_plan_is_the_reference_plan_under_its_anchors(
        words, monkeypatch):
    """At 32 lanes (the smallest size, where the reference's plan already
    leaves the default) and at the test's size: the reference's knobs,
    with ``words-cpu-64`` named ``words-torch-64``, and its floats."""
    want, rcfg = _tune_rawprog16(rpum, {}, words)
    monkeypatch.setattr(cost, "HBM_BW", 819e9)
    monkeypatch.setattr(cost, "PEAK_FLOPS", 197e12)
    got, tcfg = _tune_rawprog16(tpum, {"device": "cpu"}, words)
    assert want.non_default(rcfg) == {"fused_backend": "words-cpu-64",
                                      "word_bits": 64}
    assert got.non_default(tcfg) == {"fused_backend": "words-torch-64",
                                     "word_bits": 64}
    assert got == convert.plan_from_reference(want, "cpu")
    assert got.score_s == want.score_s
    assert got.baseline_score_s == want.baseline_score_s


def test_autotuned_plan_on_h100_anchors_leaves_the_default():
    """The module's own assert on the CPU under the port's anchors, and
    the plan a CUDA config gets from the same profile."""
    from repro_torch.autotune import Tuner, WorkloadProfile
    got, tcfg = _tune_rawprog16(tpum, {"device": "cpu"}, WORDS)
    assert got.non_default(tcfg) == {"fused_backend": "words-torch-64",
                                     "word_bits": 64}
    rng = np.random.default_rng(29)
    a, b, c = (rng.integers(0, 2**64, 32 * WORDS, dtype=np.uint64)
               for _ in range(3))
    dev = tpum.device(width=32, fuse=True, device="cpu")
    tkb._engine_rawprog16(dev, a, b, c).to_numpy()
    with tpum.profile(dev):
        tkb._engine_rawprog16(dev, a, b, c).to_numpy()
    cuda = tpum.EngineConfig(width=32, fuse=True, device="cuda")
    plan = Tuner().tune(WorkloadProfile.from_device(dev), cuda)
    assert plan.non_default(cuda) == {"fused_backend": "vertical-cuda-64",
                                      "word_bits": 64}


def test_kernel_inputs_are_the_reference_draws():
    rng = np.random.default_rng(0)
    x = tkb.kernel_inputs("cpu", WORDS)

    def planes(rows):
        return rng.integers(0, 2**32, (rows, WORDS), dtype=np.uint64
                            ).astype(np.uint32).view(np.int32)

    for key, want in (("x32", planes(31)), ("a", planes(32)),
                      ("b", planes(32))):
        np.testing.assert_array_equal(x[key].numpy(), want)
    np.testing.assert_array_equal(
        x["v"].numpy(), rng.choice([0.0, 1.2], (32, WORDS)).astype(np.float32))
    np.testing.assert_array_equal(
        x["c"].numpy(),
        (20 + rng.standard_normal((32, WORDS))).astype(np.float32))


def test_kernel_rows_compute_the_reference_functions():
    """Each ``kernel.*`` row's function on its inputs equals the
    reference's ``ref.*`` oracle on the same NumPy inputs."""
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    x = tkb.kernel_inputs("cpu", WORDS)
    j = {k: jnp.asarray(v.numpy()) for k, v in x.items()}
    want = {"kernel.maj31_oracle": jref.maj_n(j["x32"], 16),
            "kernel.maj31_bitsliced": jref.maj_n_fast(j["x32"], 16),
            "kernel.bitserial_add32": jref.bitserial_add(j["a"], j["b"]),
            "kernel.bit_transpose32": jref.bit_transpose32(j["a"]),
            "kernel.charge_share32": jref.charge_share(
                j["v"], j["c"], vdd=1.2, c_bl=116.0)}
    for name, (fn, keys, _) in tkb.KERNEL_ROWS.items():
        got = fn(*(x[k] for k in keys)).numpy()
        if name == "kernel.charge_share32":
            np.testing.assert_allclose(got, np.asarray(want[name]),
                                       rtol=1e-6, atol=1e-7)
        else:
            np.testing.assert_array_equal(got, np.asarray(want[name]))


def test_run_on_cuda_without_a_card_raises():
    """``device_us`` takes CUDA tensors: on this host a ``cuda`` run of
    the module raises instead of timing the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises((RuntimeError, AssertionError)):
        tkb.run(device="cuda", words=WORDS)


def test_phase29_rehearsed():
    """``chip_smoke.kernel_bench`` on the CPU: the kernels against their
    plain versions, the rows, the row gate against ``BENCH_kernel.json``
    and the flags; the rows written out in the BENCH schema."""
    import chip_smoke
    from repro_torch.kernels import _build
    out = chip_smoke.kernel_bench("cpu", _build)
    assert list(out["us"]) == list(tkb.ROWS)
    assert set(out["ms"]) == {"maj_n", "bitserial_add", "bit_transpose32",
                              "charge_share"}
    doc = json.loads((ROOT / "build" / "BENCH_torch_kernel_h100.json")
                     .read_text())
    assert doc["schema"] == 1 and doc["bench"] == "torch_kernel_bench"
    assert sorted(doc["rows"]) == sorted(tkb.ROWS)
    for row in COUNTER_ROWS:
        assert doc["rows"][row]["counters"]["counters"][
            "engine.ops_recorded"] >= 16


def test_one_library_built_by_two_threads_at_once(tmp_path, monkeypatch):
    """Phase 29's kernels build in a background thread while the main
    thread may build the same library: each build writes its own source
    and output and renames them into place, so both succeed and the
    library and its source are whole."""
    import os
    import threading
    from repro_torch.kernels import _build
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\n# ... -o OUT SRC\nsleep 0.2\n"
                    "eval out=\\${$(($# - 1))}\neval src=\\${$#}\n"
                    "cp \"$src\" \"$out\"\n")
    os.chmod(fake, 0o755)
    monkeypatch.setattr(_build, "nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    source = "// a kernel\n" * 10000
    errors = []

    def build():
        try:
            _build.build_many([("lib", source)])
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads) and errors == []
    assert (tmp_path / "build" / "lib.so").read_text() == source
    assert (tmp_path / "build" / "lib.cu").read_text() == source
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == [
        "lib.cu", "lib.so"]
