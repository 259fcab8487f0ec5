"""The Monte-Carlo figures through the port (``benchmarks/torch_fig03``,
``fig04``, ``fig11``, ``fig14``, ``fig15``, ``fig16``, ``fig18``) held
against the reference's modules, one case per row:

* the port on the CPU (seed 0) lies within each statistical number's
  tolerance of the reference's row in
  ``benchmarks/torch_figures_reference.json``, and every other number
  and word is the reference's;
* the figure arithmetic is exact: fed the reference's own success points
  (its ``SuccessRateDb``) or the reference's own analog draws, a port
  module prints the reference's ``derived`` string byte for byte;
* the committed JSON equals a fresh run of the reference.

``python tests/test_torch_figures_analog.py --regen`` rebuilds the JSON:
every reference module of ``benchmarks/run.py`` but ``kernel_bench``,
and the port's Monte-Carlo modules and reliability sweep on the CPU under
``SEEDS`` seeds. A number that moves across those seeds is
``statistical``, with tolerance ``max(4 * sqrt(2) * sd, one printed
unit)`` (two independent draws, four standard deviations); a number that
does not is ``exact``; fig20's ``host_numpy`` is a host wall.
"""

from __future__ import annotations

import importlib
import json
import math
import pathlib
import statistics
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import common, torch_run  # noqa: E402

MODULES = ("fig03_fracdram_success", "fig04_process_variation",
           "fig11_input_replication", "fig14_maj3_success",
           "fig15_majm_success", "fig16_spatial_success",
           "fig18_nrg_sensitivity")
# The modules whose rows hang on the port's random draws.
STATISTICAL_MODULES = MODULES + ("reliability_sweep",)
SEEDS = 10
WALLS = ("host_numpy",)

# Read at import for the parametrization (not when run to rebuild it).
REFERENCE = torch_run.load_reference() if __name__ != "__main__" else {}
ROWS = [n for n, e in REFERENCE.items() if e["module"] in MODULES]


class _Memo:
    """A reference module's ``analog`` that computes each distinct call
    once, so the reference's run and the port fed its draws share it."""

    def __init__(self, analog):
        self._analog = analog
        self._cache = {}

    def __getattr__(self, name):
        fn = getattr(self._analog, name)

        def call(key, *args, **kw):
            k = (name, np.asarray(key).tobytes(), repr(args),
                 repr(sorted(kw.items())))
            if k not in self._cache:
                self._cache[k] = fn(key, *args, **kw)
            return self._cache[k]
        return call


class RefDraws:
    """The port's ``model`` argument of fig04/fig11 on the reference's
    draws: each call is the reference's analog function on the
    reference's key and profile, its arrays handed back as CPU tensors."""

    def __init__(self, analog, key):
        self.analog = analog
        self.key = key

    def __getattr__(self, name):
        from repro.core.profiles import PROFILES
        fn = getattr(self.analog, name)

        def call(profile, *args, **kw):
            out = fn(self.key, PROFILES[profile.name], *args, **kw)
            if isinstance(out, tuple):
                return out
            return torch.from_numpy(np.asarray(out).copy())
        return call


@pytest.fixture(scope="module")
def runs():
    """Per module: the reference's rows, the port's rows on the CPU, and
    the port's rows fed the reference's points or draws (name -> derived
    each)."""
    out = {}
    dbs = {}
    for name in MODULES:
        ref_mod = importlib.import_module(f"benchmarks.{name}")
        port_mod = torch_run.module(name)
        saved, made = {}, []
        if hasattr(ref_mod, "SuccessRateDb"):
            # One db per size, shared by the reference's run and the port's.
            real = ref_mod.SuccessRateDb

            def shared(real=real, **kw):
                key = tuple(sorted(kw.items()))
                if key not in dbs:
                    dbs[key] = real(**kw)
                made.append(dbs[key])
                return dbs[key]
            saved["SuccessRateDb"] = real
            ref_mod.SuccessRateDb = shared
        else:
            saved["analog"] = ref_mod.analog
            ref_mod.analog = _Memo(ref_mod.analog)
        try:
            ref = ref_mod.run()
            if made:
                fed = port_mod.run(device="cpu", db=made[-1])
            else:
                fed = port_mod.run(device="cpu",
                                   model=RefDraws(ref_mod.analog, ref_mod.KEY))
        finally:
            for attr, val in saved.items():
                setattr(ref_mod, attr, val)
        port = port_mod.run(device="cpu")
        out[name] = {k: {n: d for n, _, d in rows}
                     for k, rows in (("ref", ref), ("port", port),
                                     ("fed", fed))}
    return out


def _module_of(row: str) -> str:
    return REFERENCE[row]["module"]


@pytest.mark.parametrize("row", ROWS)
def test_port_row_within_tolerance(runs, row):
    got = runs[_module_of(row)]["port"][row]
    assert torch_run.check_row(got, REFERENCE[row]) == []


@pytest.mark.parametrize("row", ROWS)
def test_figure_arithmetic_exact_on_reference_points(runs, row):
    r = runs[_module_of(row)]
    assert r["fed"][row] == r["ref"][row]


@pytest.mark.parametrize("row", ROWS)
def test_committed_reference_is_fresh(runs, row):
    assert runs[_module_of(row)]["ref"][row] == REFERENCE[row]["derived"]


def test_row_sets_and_order(runs):
    for name in MODULES:
        r = runs[name]
        assert list(r["port"]) == list(r["ref"]) == [
            n for n in REFERENCE if REFERENCE[n]["module"] == name]


def test_fig16_booleans_and_kinds():
    """fig16's booleans sit in the template (equal, never a tolerance);
    every paper constant is exact; every tolerance is at least one
    printed unit and follows the stored rule."""
    assert "everywhere_better=True m_shape=False" in (
        REFERENCE["fig16.spatial"]["template"])
    for e in REFERENCE.values():
        for f in e["fields"]:
            if f["name"].startswith("paper"):
                assert f["kind"] == "exact", (e["name"], f)
            if f["kind"] == "statistical":
                want = max(4 * math.sqrt(2) * f["sd"],
                           torch_run.unit(f["text"]))
                assert f["tol"] == pytest.approx(want, rel=1e-5)
                assert f["tol"] >= torch_run.unit(f["text"])


def test_fresh_draws_reuse_one_seed():
    """fig04/fig11 draw each call from a generator seeded anew, so two
    calls see the same bitlines (the reference reuses one PRNG key)."""
    from benchmarks.torch_fig04_process_variation import FreshDraws
    from repro_torch.core.profiles import MFR_H
    model = FreshDraws(4, "cpu")
    a = model.deviation_distribution(MFR_H, m_inputs=3, copies=1,
                                     n_neutral=1, ones=2, n_bitlines=64)
    b = model.deviation_distribution(MFR_H, m_inputs=3, copies=1,
                                     n_neutral=1, ones=2, n_bitlines=64)
    assert torch.equal(a, b)


# --------------------------------------------------------------------- #
# Regeneration of benchmarks/torch_figures_reference.json                #
# --------------------------------------------------------------------- #


def _seed_values(name: str) -> dict[str, list[str]]:
    """Row -> the port's ``derived`` on the CPU under seeds 0..SEEDS-1."""
    out: dict[str, list[str]] = {}
    for s in range(SEEDS):
        for row, _, derived in torch_run.module(name).run(device="cpu",
                                                         seed=s):
            out.setdefault(row, []).append(derived)
        common.drain_counters()
    return out


def build_reference() -> dict:
    rows = []
    for name in torch_run.FIGURE_MODULES:
        ref = importlib.import_module(f"benchmarks.{name}").run()
        common.drain_counters()
        seeded = _seed_values(name) if name in STATISTICAL_MODULES else {}
        for row, _, derived in ref:
            template, nums = torch_run.split(derived)
            per_seed = [torch_run.split(d) for d in seeded.get(row, [])]
            # A seed may print other words (fig16's m_shape): counted,
            # never folded into a tolerance.
            others: dict[str, int] = {}
            for t, n in per_seed:
                if len(n) != len(nums):
                    raise AssertionError(f"{row}: a seed prints {t!r}, "
                                         f"the reference {template!r}")
                if t != template:
                    others[t] = others.get(t, 0) + 1
            fields = []
            for i, (field, text) in enumerate(nums):
                entry = {"name": field, "text": text, "kind": "exact",
                         "tol": 0.0}
                vals = [float(n[i][1]) for _, n in per_seed]
                if field in WALLS:
                    entry["kind"] = "wall"
                elif len(set(vals)) > 1:
                    sd = float(f"{statistics.stdev(vals):.6g}")
                    tol = max(4 * math.sqrt(2) * sd, torch_run.unit(text))
                    entry.update(kind="statistical", sd=sd,
                                 tol=float(f"{tol:.6g}"),
                                 seeds=[min(vals), max(vals)])
                fields.append(entry)
            rows.append({"module": name, "name": row, "derived": derived,
                         "template": template, "fields": fields,
                         **({"seed_templates": others} if others else {})})
    return {
        "about": "The reference's rows (benchmarks/run.py's modules but "
                 "kernel_bench, on this repo's CPU test host); each "
                 "number exact, statistical (tol = max(4*sqrt(2)*sd, one "
                 "printed unit), sd over the port's CPU runs under "
                 f"seeds 0..{SEEDS - 1}, 'seeds' their min and max) or a "
                 "host wall; seed_templates counts the seeds that printed "
                 "other words. us_per_call is a host wall and not kept. "
                 "Rebuilt by python tests/test_torch_figures_analog.py "
                 "--regen.",
        "seeds": SEEDS,
        "rows": rows,
    }


if __name__ == "__main__" and "--regen" in sys.argv:
    sys.path.insert(0, str(ROOT / "src"))
    doc = build_reference()
    with open(torch_run.REFERENCE_PATH, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    print(f"wrote {torch_run.REFERENCE_PATH} ({len(doc['rows'])} rows)")
