"""The reliability sweep through the port (``benchmarks/
torch_reliability_sweep.py``) held against the reference's
``benchmarks/reliability_sweep.py``, one case per row: within the
tolerances of ``benchmarks/torch_figures_reference.json``, ``exact=1``
on every row that reports it, and the committed rows equal a fresh
reference run. The reference's counts at ``inject_pv6_fs10``
(``corrected=0``, ``fallbacks=1``) are among the port's own outcomes
over seeds, so they are statistical, not a fault. Also the whole port
runner on the CPU: every row of the reference's runner, in order (the
figure rows against the JSON, ``kernel_bench``'s by name against
``BENCH_kernel.json``), and ``--emit-dir``."""

from __future__ import annotations

import contextlib
import io
import json
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import common, torch_run  # noqa: E402

NAME = "reliability_sweep"
REFERENCE = torch_run.load_reference()
ROWS = [n for n, e in REFERENCE.items() if e["module"] == NAME]
SEEDS = 10


@pytest.fixture(scope="module")
def runs():
    from benchmarks import reliability_sweep
    ref = reliability_sweep.run()
    common.drain_counters()
    port = [torch_run.module(NAME).run(device="cpu", seed=s)
            for s in range(SEEDS)]
    common.drain_counters()
    return {"ref": {n: d for n, _, d in ref},
            "seeds": [{n: d for n, _, d in rows} for rows in port]}


def _fields(derived: str) -> dict[str, str]:
    return dict(torch_run.split(derived)[1])


@pytest.mark.parametrize("row", ROWS)
def test_port_row_within_tolerance(runs, row):
    assert torch_run.check_row(runs["seeds"][0][row], REFERENCE[row]) == []


@pytest.mark.parametrize("row", ROWS)
def test_exact_on_every_seed(runs, row):
    """The vote/retry loop never returns a wrong bit: ``exact=1`` under
    every seed, and the committed reference row says so too."""
    for seed_rows in runs["seeds"] + [runs["ref"]]:
        got = _fields(seed_rows[row])
        assert got.get("exact", "1") == "1", (row, seed_rows[row])
    fields = {f["name"]: f for f in REFERENCE[row]["fields"]}
    if "exact" in fields:
        assert fields["exact"] == {"name": "exact", "text": "1",
                                   "kind": "exact", "tol": 0.0}


@pytest.mark.parametrize("row", ROWS)
def test_committed_reference_is_fresh(runs, row):
    assert runs["ref"][row] == REFERENCE[row]["derived"]


def test_reference_counts_within_port_spread(runs):
    """``inject_pv6_fs10``: the reference corrects 0 bits and falls back
    to the oracle once; the port's seed 0 corrects 76 and never falls
    back. Over the port's seeds both outcomes occur, and the reference's
    is among them."""
    row = "rel.inject_pv6_fs10"
    ref = _fields(runs["ref"][row])
    seen = [_fields(s[row]) for s in runs["seeds"]]
    assert (ref["corrected"], ref["fallbacks"]) in {
        (s["corrected"], s["fallbacks"]) for s in seen}
    assert {(s["corrected"] == "0", s["fallbacks"]) for s in seen} == {
        (True, "1"), (False, "0")}
    fields = {f["name"]: f for f in REFERENCE[row]["fields"]}
    assert fields["corrected"]["kind"] == "statistical"
    assert fields["fallbacks"]["kind"] == "statistical"


def test_whole_runner_on_cpu(tmp_path, monkeypatch):
    """Every row the reference's runner prints, in its order, exit 0:
    the figure modules' rows held against the committed JSON (a fresh
    reference run of them, in ``benchmarks/run.py``'s order), and
    ``kernel_bench``'s rows (host walls and device times, at 1024 words
    a plane here) by name against ``BENCH_kernel.json``, between
    ``fig20_realworld``'s and the sweep's."""
    from benchmarks import torch_kernel_bench
    monkeypatch.setattr(torch_kernel_bench, "W", 1024)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(
            io.StringIO()):
        rc = torch_run.main(["--device", "cpu"])
    assert rc == 0
    lines = buf.getvalue().splitlines()
    assert lines[0] == "name,us_per_call,derived"
    names = [x.split(",")[0] for x in lines[1:]]
    figures = [n for n in names if n not in torch_kernel_bench.ROWS]
    assert figures == list(REFERENCE)
    cut = [i for i, n in enumerate(names) if n.startswith("rel.")][0]
    assert names[cut - len(torch_kernel_bench.ROWS):cut] == list(
        torch_kernel_bench.ROWS)
    baseline = json.loads((ROOT / "BENCH_kernel.json").read_text())
    assert set(torch_kernel_bench.ROWS) == set(baseline["rows"])
    bad = []
    for line in lines[1:]:
        name, _, derived = line.split(",", 2)
        if name in REFERENCE:
            bad += torch_run.check_row(derived[1:-1], REFERENCE[name])
    assert bad == []


def test_emit_dir(tmp_path):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(
            io.StringIO()):
        rc = torch_run.main(["--only", "reliability", "--device", "cpu",
                             "--emit-dir", str(tmp_path)])
    assert rc == 0
    doc = json.loads((tmp_path / "BENCH_torch_reliability_h100.json")
                     .read_text())
    assert doc["bench"] == "torch_reliability_sweep"
    assert sorted(doc["rows"]) == sorted(ROWS)  # the file sorts its keys
    counters = doc["rows"]["rel.inject_pv5_fs40"]["counters"]["counters"]
    assert counters["reliability.flushes"] >= 1


def test_phase27_rehearsed():
    """``chip_smoke.figures`` on the CPU: every module, every row held
    against the committed reference, the rows written out."""
    import chip_smoke
    from repro_torch.kernels import _build
    out = chip_smoke.figures("cpu", _build)
    assert set(out["seconds"]) == set(torch_run.FIGURE_MODULES)
    assert "kernel_bench" not in out["seconds"]
    rows = (ROOT / "build" / "figures_rows.csv").read_text().splitlines()
    assert [x.split(",")[0] for x in rows[1:]] == list(REFERENCE)
