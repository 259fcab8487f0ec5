"""Port cost plane vs the reference: EngineStats must be float-identical.

The port charges every op at record time through its copy of the cost
model, with success rates from the table checked into the package
(``repro_torch/core/success_points.json``). These tests hold
``EngineStats.as_dict()`` of a port device (on the CPU) equal to the
reference's, exactly, and regenerate the table's points from the
reference's ``default_db()``.

Regenerate the table after a change to the reference's characterization:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_cost_plane.py --regen
"""

from __future__ import annotations

import dataclasses
import json
import sys

import numpy as np
import pytest

import repro.pum as rpum
import repro_torch.pum as tpum
from repro_torch.core import charact as tcharact


def prog16(dev, a, b, c):
    """The fused-pipeline staple (``benchmarks/kernel_bench.py``)."""
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


def mulprog16(dev, a, b, c):
    """The mul/div staple (``benchmarks/kernel_bench.py``)."""
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


PROGRAMS = {"prog16": prog16, "mulprog16": mulprog16}


def _operands(width: int, n: int = 96, seed: int = 0):
    rng = np.random.default_rng(seed)
    hi = 1 << width
    return [rng.integers(0, hi, n, dtype=np.uint64) if width < 64 else
            rng.integers(0, 2**64 - 1, n, dtype=np.uint64, endpoint=True)
            for _ in range(3)]


@pytest.mark.parametrize("prog", sorted(PROGRAMS))
@pytest.mark.parametrize("width", [8, 32, 64])
@pytest.mark.parametrize("mfr", ["H", "M"])
def test_stats_identical_to_reference(mfr, width, prog):
    fn = PROGRAMS[prog]
    a, b, c = _operands(width)
    for use_pulsar in (True, False):
        for chained in (False, True):
            cfg = dict(mfr=mfr, width=width, use_pulsar=use_pulsar,
                       chained=chained)
            rdev = rpum.device(**cfg)
            want_out = fn(rdev, a, b, c).to_numpy()
            want = rdev.stats.as_dict()
            for fuse in (True, False):
                tdev = tpum.device(device="cpu", fuse=fuse, **cfg)
                got_out = fn(tdev, a, b, c).to_numpy()
                assert tdev.stats.as_dict() == want, (cfg, fuse)
                np.testing.assert_array_equal(got_out, want_out)


@pytest.mark.parametrize("use_pulsar", [True, False])
def test_mfr_s_has_no_viable_config_in_either_package(use_pulsar):
    """Samsung parts activate one row only: no MAJ config exists, and both
    packages refuse the first op."""
    a, b, c = _operands(8)
    with pytest.raises((AssertionError, ValueError)):
        prog16(rpum.device(mfr="S", width=8, use_pulsar=use_pulsar),
               a, b, c)
    with pytest.raises(ValueError):
        prog16(tpum.device(mfr="S", width=8, use_pulsar=use_pulsar,
                           device="cpu"), a, b, c)


def test_op_effective_ns_matches_reference():
    rdev = rpum.device(mfr="M", width=16)
    tdev = tpum.device(mfr="M", width=16, device="cpu")
    for kind in ("and2", "xor2", "add", "mul", "div", "compare",
                 "popcount", "reduce_and", "reduce_xor"):
        assert (tdev.engine.op_effective_ns(kind)
                == rdev.engine.op_effective_ns(kind)), kind


def _reference_points(mfr: str) -> list[dict]:
    from repro.core.charact import default_db
    db = default_db()
    return [dict(dataclasses.asdict(db.point(mfr, m, n, plan_style=style)),
                 plan_style=style)
            for m, n, style in tcharact.table_points(mfr)]


def test_success_table_matches_reference_default_db():
    """The points a default ``mfr="M"`` device queries, and those the
    paper's figures query, regenerated from the reference's Monte-Carlo
    ``default_db()``, equal the checked-in table exactly."""
    want = _reference_points("M")
    table = [p for p in tcharact.load_points() if p["mfr"] == "M"]
    assert table == want
    # 7 pow2 planning points + the FracDRAM MAJ3@4, then the figures'
    # max-plan MAJ3@8/16, MAJ5@8/16 and MAJ7@8/16 (MAJ3@4 is already
    # there; Mfr M's fan-in cap is 7 and its row cap 16).
    assert len(want) == 14


def test_success_table_covers_every_planning_query():
    db = tcharact.default_db()
    for mfr in ("H", "M", "S"):
        for m, n, style in tcharact.query_points(mfr):
            assert db.point(mfr, m, n, plan_style=style).n_rg == n
    with pytest.raises(NotImplementedError, match="analog Monte-Carlo"):
        db.point("H", 9, 8, plan_style="pow2")   # no such plan
    with pytest.raises(NotImplementedError, match="analog Monte-Carlo"):
        db.point("H", 3, 32, subarray_frac=0.5)


def regen() -> None:
    """Rewrite the port's success table from the reference."""
    points = [p for mfr in ("H", "M", "S") for p in _reference_points(mfr)]
    with open(tcharact.TABLE_PATH, "w", encoding="utf-8") as f:
        json.dump({"source": "repro.core.charact.default_db() (seed 0)",
                   "points": points}, f, indent=1)
        f.write("\n")
    print(f"wrote {len(points)} points to {tcharact.TABLE_PATH}")


if __name__ == "__main__":
    if sys.argv[1:] == ["--regen"]:
        regen()
    else:
        sys.exit("usage: test_torch_cost_plane.py --regen")
