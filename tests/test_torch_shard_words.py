"""The ``shard-words`` fused backend of the port against the reference.

* the three ``shard-words`` tests of ``tests/pum/test_width64_parity.py``
  and the ``sharded`` registry cases of
  ``tests/pum/test_device_and_registry.py`` through the port;
* flushes sharded over 1, 3 and 8 explicit CPU devices (a ``shard-words``
  evaluator registered over ``words_mesh([cpu] * n)``, the port's
  counterpart of the reference's forced host devices) at lane counts that
  do not divide ``32 x n``: bit-exact against the port's eager device, the
  reference's eager device and ``words-torch``, with equal
  ``EngineStats``;
* the pipeline itself on raw wire words, and a ``pum.capture`` replay.

The multi-card case runs on a host with several cards
(``tests/test_torch_cuda.py``).
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import repro.pum as rpum
import repro_torch.pum as tpum
from repro_torch import backends
from repro_torch.core.engine import PulsarEngine
from repro_torch.distributed.sharding import words_mesh
from repro_torch.kernels import fused_program as tfp
from repro_torch.kernels.plane_layout import LAYOUT64

pytestmark = pytest.mark.sharded

CPU = torch.device("cpu")


@pytest.fixture
def shards():
    """``shards(n)``: the name of a ``shard-words`` evaluator over ``n``
    CPU devices, registered for the test."""
    names = []

    def make(n: int) -> str:
        name = f"shard-words-cpu{n}"
        backends.register_backend(
            name, functools.partial(tfp.build_sharded_words_pipeline,
                                    mesh=words_mesh([CPU] * n)),
            capabilities=("fused", "sharded"), max_width=32, priority=15,
            available=backends.multi_card)
        names.append(name)
        return name

    yield make
    for name in names:
        backends.unregister_backend(name)


def _ops(x, b):
    t = (x + b) * x
    q, r = divmod(t, b)
    return t, q, r, t.popcount()


# --------------------------------------------------------------------- #
# tests/pum/test_width64_parity.py:357-410 through the port
# --------------------------------------------------------------------- #


def test_shard_words_single_device_parity():
    """Requestable by name even on one device: same results/stats as the
    default fused path and as eager."""
    rng = np.random.default_rng(31)
    a = rng.integers(0, 1 << 32, 500, dtype=np.uint64)
    b = rng.integers(0, 1 << 32, 500, dtype=np.uint64)
    eager = tpum.device(width=32, fuse=False, device="cpu")
    sharded = tpum.device(width=32, fuse=True, fused_backend="shard-words",
                          device="cpu")
    assert sharded.engine.fused_backend == "shard-words"

    def run(dev):
        x = dev.asarray(a)
        t = (x + b) * x
        return np.asarray(t ^ b)

    np.testing.assert_array_equal(run(eager), run(sharded))
    assert eager.stats == sharded.stats


def test_shard_words_rejects_wide_layout():
    with pytest.raises(ValueError, match="layouts"):
        PulsarEngine(width=48, fuse=True, fused_backend="shard-words",
                     device="cpu")
    with pytest.raises(ValueError, match="no fused"):
        PulsarEngine(width=16, fuse=True, fused_backend="fast", device="cpu")
    prog64 = tfp.FusedProgram(width=48, n_inputs=2,
                              ops=(tfp.FusedOp("add", (0, 1)),),
                              outputs=(2,), layout=LAYOUT64)
    with pytest.raises(ValueError, match="32-bit word layout"):
        tfp.build_sharded_words_pipeline(prog64)


def test_shard_words_multidevice_parity(shards):
    """One flush executes one program across 8 CPU shards; results and
    EngineStats identical to single-device eager."""
    rng = np.random.default_rng(5)
    a = rng.integers(0, 1 << 32, 1000, dtype=np.uint64)
    b = rng.integers(0, 1 << 32, 1000, dtype=np.uint64)
    b[::7] = 0
    eager = tpum.device(width=32, fuse=False, device="cpu")
    fused = tpum.device(width=32, fuse=True, fused_backend=shards(8),
                        device="cpu")

    def run(d):
        return [np.asarray(v) for v in _ops(d.asarray(a), b)]

    for w, g in zip(run(eager), run(fused)):
        np.testing.assert_array_equal(w, g)
    assert eager.stats == fused.stats


# --------------------------------------------------------------------- #
# tests/pum/test_device_and_registry.py:187-198, the sharded cases
# --------------------------------------------------------------------- #


def test_select_backend_sharded_capability(monkeypatch):
    assert "shard-words" in tpum.available_backends("fused")
    assert tpum.available_backends("sharded") == ("shard-words",)
    with pytest.raises(LookupError):  # layout filter: sharded is 32-only
        tpum.select_backend(require="sharded", device="cpu", layout=64)
    spec = backends.get_backend("shard-words")
    assert (spec.max_width, spec.priority, spec.layouts) == (
        32, 15, frozenset({32}))
    cuda = torch.device("cuda")
    # Auto-selected only on a CUDA device of a multi-card host, where the
    # single-card kernels (priority 20) still win a plain fused query.
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert not spec.available(cuda)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert spec.available(cuda) and not spec.available(CPU)
    assert tpum.select_backend(require="sharded", device=cuda,
                               layout=32).name == "shard-words"
    assert tpum.select_backend(require="fused", device=cuda, width=32,
                               layout=32).name == "vertical-cuda"
    with pytest.raises(LookupError):
        tpum.select_backend(require="sharded", device="cpu", layout=32)


def test_shard_backend_skips_sharded_and_pins():
    """Each shard runs its device's own evaluator, whatever a selection
    pin names for the flush."""
    with backends.selection_override("fused", "shard-words"):
        assert tpum.select_backend(require="fused", device="cpu",
                                   width=32).name == "shard-words"
        assert backends.shard_backend("cpu", 32, 32).name == "words-torch"
        dev = tpum.device(width=32, device="cpu")
        x = dev.asarray(np.arange(100, dtype=np.uint64))
        assert ((x + x) * x).to_numpy().tolist() == [
            (2 * i * i) & 0xFFFFFFFF for i in range(100)]


# --------------------------------------------------------------------- #
# 1, 3 and 8 CPU shards against both eager devices and words-torch
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("n_lanes", [1000, 3 * 32 * 7 + 5])
@pytest.mark.parametrize("n_dev", [1, 3, 8])
def test_sharded_flush_matches_both_packages(shards, n_dev, n_lanes):
    rng = np.random.default_rng(n_dev * 1000 + n_lanes)
    a = rng.integers(0, 1 << 32, n_lanes, dtype=np.uint64)
    b = rng.integers(0, 1 << 32, n_lanes, dtype=np.uint64)
    b[::5] = 0
    devs = {
        "sharded": tpum.device(width=32, fused_backend=shards(n_dev),
                               device="cpu"),
        "port eager": tpum.device(width=32, fuse=False, device="cpu"),
        "words-torch": tpum.device(width=32, fused_backend="words-torch",
                                   device="cpu"),
        "reference eager": rpum.device(width=32, fuse=False),
    }
    got = {k: [np.asarray(v) for v in _ops(d.asarray(a), b)]
           for k, d in devs.items()}
    for k, outs in got.items():
        for w, g in zip(got["reference eager"], outs):
            np.testing.assert_array_equal(g, w, err_msg=k)
    want = devs["reference eager"].stats.as_dict()
    for k, d in devs.items():
        assert d.stats.as_dict() == want, k


@pytest.mark.parametrize("n_dev", [1, 3, 8])
def test_sharded_pipeline_on_wire_words(n_dev):
    """The pipeline on raw int32 wire words of a lane count that pads: the
    words-torch evaluator's outputs, sliced back to the input length, on
    the leaves' device."""
    prog = tfp.FusedProgram(
        width=32, n_inputs=2,
        ops=(tfp.FusedOp("add", (0, 1)), tfp.FusedOp("mul", (2, 0)),
             tfp.FusedOp("xor", (3, 1))),
        outputs=(3, 4))
    rng = np.random.default_rng(n_dev)
    n = 32 * 11
    leaves = [torch.from_numpy(rng.integers(-2**31, 2**31, n, np.int64)
                               .astype(np.int32)) for _ in range(2)]
    run = tfp.build_sharded_words_pipeline(prog,
                                           mesh=words_mesh([CPU] * n_dev))
    got = run(*leaves)
    want = tfp.run_program_words(prog, leaves)
    assert len(got) == 2
    for g, w in zip(got, want):
        assert g.device == CPU and g.shape == (n,)
        assert torch.equal(g, w)


def test_capture_replays_through_shard_words(shards):
    """A captured program replayed on a 3-shard device: each replay equals
    the reference's capture, and the stats equal re-recording."""
    rng = np.random.default_rng(11)
    a = rng.integers(0, 1 << 31, 3000, dtype=np.uint64)
    b = rng.integers(0, 1 << 32, 3000, dtype=np.uint64)

    def fn(x, y):
        return (x + y) * x ^ y

    name = shards(3)
    cap = tpum.device(width=32, fused_backend=name, device="cpu")
    raw = tpum.device(width=32, fused_backend=name, device="cpu")
    ref = rpum.device(width=32)
    prog, rprog = cap.capture(fn), ref.capture(fn)
    for k in range(4):
        x = a + np.uint64(k)
        got = prog(x, b)
        np.testing.assert_array_equal(got, rprog(x, b))
        np.testing.assert_array_equal(got, fn(raw.asarray(x), b).to_numpy())
    assert prog.n_records == 1 and prog.n_replays == 3
    assert cap.stats == raw.stats
    assert cap.stats.as_dict() == ref.stats.as_dict()
    for d in (cap, raw, ref):
        d.close()
