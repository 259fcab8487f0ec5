"""The analytic and modeled figures through the port (``benchmarks/
torch_fig05``, ``table1``, ``fig17``, ``fig19``, ``bank_parallelism``,
``fig20``) held against the reference's modules, one case per row: every
number and word the reference prints, byte for byte, but fig20's
``host_numpy=`` (a host wall); the committed rows of
``benchmarks/torch_figures_reference.json`` equal a fresh run of the
reference; and ``python -m benchmarks.torch_run`` prints the reference
runner's header and rows and exits 1 when a module fails."""

from __future__ import annotations

import contextlib
import importlib
import io
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import common, torch_run  # noqa: E402

MODULES = ("fig05_majm_speedup_model", "table1_nrg_discovery",
           "fig17_microbenchmarks", "fig19_destruction",
           "bank_parallelism", "fig20_realworld")

REFERENCE = torch_run.load_reference()
ROWS = [n for n, e in REFERENCE.items() if e["module"] in MODULES]


@pytest.fixture(scope="module")
def runs():
    """Per module: the reference's and the port's (CPU) rows, name ->
    derived."""
    out = {}
    for name in MODULES:
        ref = importlib.import_module(f"benchmarks.{name}").run()
        common.drain_counters()
        port = torch_run.module(name).run(device="cpu")
        common.drain_counters()
        out[name] = {"ref": {n: d for n, _, d in ref},
                     "port": {n: d for n, _, d in port}}
    return out


@pytest.mark.parametrize("row", ROWS)
def test_port_row_exact(runs, row):
    entry = REFERENCE[row]
    assert {f["kind"] for f in entry["fields"]} <= {"exact", "wall"}
    got = runs[entry["module"]]["port"][row]
    assert torch_run.check_row(got, entry) == []
    if all(f["kind"] == "exact" for f in entry["fields"]):
        assert got == runs[entry["module"]]["ref"][row]


@pytest.mark.parametrize("row", ROWS)
def test_committed_reference_is_fresh(runs, row):
    entry = REFERENCE[row]
    fresh = runs[entry["module"]]["ref"][row]
    assert torch_run.check_row(fresh, entry) == []
    if all(f["kind"] == "exact" for f in entry["fields"]):
        assert fresh == entry["derived"]


def test_row_sets_and_order(runs):
    for name in MODULES:
        r = runs[name]
        assert list(r["port"]) == list(r["ref"]) == [
            n for n in REFERENCE if REFERENCE[n]["module"] == name]


def test_only_walls_are_fig20_host_numpy():
    walls = {(e["module"], f["name"]) for e in REFERENCE.values()
             for f in e["fields"] if f["kind"] == "wall"}
    assert walls == {("fig20_realworld", "host_numpy")}


def _main(module, argv: list[str]) -> tuple[int, str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(
            io.StringIO()):
        rc = module.main(argv)
    return rc, buf.getvalue()


def test_cli_only_fig05_matches_reference_runner(monkeypatch):
    from benchmarks import run as ref_run
    assert torch_run.MODULES == ref_run.MODULES
    rc, out = _main(torch_run, ["--only", "fig05", "--device", "cpu"])
    assert rc == 0
    monkeypatch.setattr(sys, "argv", ["run", "--only", "fig05"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ref_run.main()
    lines, ref_lines = out.splitlines(), buf.getvalue().splitlines()
    assert lines[0] == ref_lines[0] == "name,us_per_call,derived"
    assert [x.split(",")[0] for x in lines] == [
        x.split(",")[0] for x in ref_lines]
    assert [x.split(",", 2)[2] for x in lines[1:]] == [
        x.split(",", 2)[2] for x in ref_lines[1:]]


def test_cli_failed_module_exits_1(monkeypatch):
    class Broken:
        @staticmethod
        def run(device="cuda"):
            raise RuntimeError("planted")

    monkeypatch.setattr(torch_run, "module", lambda name: Broken)
    rc, out = _main(torch_run, ["--only", "fig05", "--device", "cpu"])
    assert rc == 1
    assert out.splitlines()[1] == (
        'fig05_majm_speedup_model,-1,"FAILED: RuntimeError: planted"')


def test_cli_no_cpu_fallback_without_a_card():
    """On a host without CUDA the default device raises in the module,
    and the runner exits 1 instead of running on the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-m", "benchmarks.torch_run", "--only", "fig17"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1
    assert proc.stdout.splitlines()[1].startswith(
        'fig17_microbenchmarks,-1,"FAILED: ')
