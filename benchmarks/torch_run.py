"""The paper's figures and tables, and the kernel and engine
microbenchmarks, through the PyTorch port: one module per reference
module of ``benchmarks/run.py``, each ``benchmarks/torch_<name>.py``.

  PYTHONPATH=src python -m benchmarks.torch_run [--only fig17]
      [--device cpu] [--emit-dir DIR]

Prints the reference's ``name,us_per_call,derived`` CSV with the same
rows in the same order. ``--device`` (default ``cuda``) is where every
module runs; a module never falls back to the CPU. ``--emit-dir`` writes
the gated modules' rows as ``BENCH_torch_*_h100.json`` (the schema of
``benchmarks/common.py``; ``python tools/bench_compare.py
BENCH_kernel.json DIR/BENCH_torch_kernel_h100.json --check-rows``
compares the kernel rows' set with the reference's). A failed module
prints a ``name,-1,"FAILED: ..."`` row and the process exits 1.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import pathlib
import re
import sys
import traceback

from benchmarks import common

# The reference's rows with each number's kind and tolerance, rebuilt by
# ``python tests/test_torch_figures_analog.py --regen``.
REFERENCE_PATH = pathlib.Path(__file__).with_name(
    "torch_figures_reference.json")
NUMBER = re.compile(r"-?\d+(?:\.\d+)?(?:e[-+]?\d+)?")

BENCH_NAMES = {
    "kernel_bench": "BENCH_torch_kernel_h100.json",
    "bank_parallelism": "BENCH_torch_bankpar_h100.json",
    "reliability_sweep": "BENCH_torch_reliability_h100.json",
}

MODULES = [
    "fig03_fracdram_success",
    "fig04_process_variation",
    "fig05_majm_speedup_model",
    "table1_nrg_discovery",
    "fig11_input_replication",
    "fig14_maj3_success",
    "fig15_majm_success",
    "fig16_spatial_success",
    "fig17_microbenchmarks",
    "bank_parallelism",
    "fig18_nrg_sensitivity",
    "fig19_destruction",
    "fig20_realworld",
    "kernel_bench",
    "reliability_sweep",
]
# The modules whose rows ``REFERENCE_PATH`` holds: all but kernel_bench,
# whose rows are host walls and device times (held by name against
# ``BENCH_kernel.json`` instead).
FIGURE_MODULES = [m for m in MODULES if m != "kernel_bench"]


def module(name: str):
    """The port's module for the reference module ``name``."""
    return importlib.import_module(f"benchmarks.torch_{name}")


def split(derived: str) -> tuple[str, list[tuple[str, str]]]:
    """``derived`` as its template (every number replaced by ``{}``) and
    its numbers as ``(name, text)``: the name is the text before the
    number in its space-separated token, up to any ``=`` and stripped of
    ``:[(,+`` (``sim=`` and ``iqr=[0.750,`` give ``sim`` and ``iqr``,
    ``N8:`` gives ``N8``), with ``#2``, ``#3``... where it repeats."""
    names: dict[str, int] = {}
    out = []
    for m in NUMBER.finditer(derived):
        start = derived.rfind(" ", 0, m.start()) + 1
        key = derived[start:m.start()].split("=")[0].strip(":[(,+") or "_"
        names[key] = names.get(key, 0) + 1
        out.append((key if names[key] == 1 else f"{key}#{names[key]}",
                    m.group()))
    return NUMBER.sub("{}", derived), out


def unit(text: str) -> float:
    """One unit in the last printed place of ``text``."""
    mant = text.split("e")[0]
    places = len(mant.split(".")[1]) if "." in mant else 0
    exp = int(text.split("e")[1]) if "e" in text else 0
    return 10.0 ** (exp - places)


def load_reference(path=REFERENCE_PATH) -> dict:
    """Row name -> the reference's entry (``derived``, ``template``,
    ``fields``: ``name``, ``text``, ``kind``, ``tol``)."""
    with open(path, encoding="utf-8") as f:
        return {r["name"]: r for r in json.load(f)["rows"]}


def check_row(derived: str, entry: dict) -> list[str]:
    """How ``derived`` disagrees with the reference's ``entry``: the
    templates must be equal (words, booleans, units), an ``exact`` number
    byte-equal, a ``statistical`` one within its ``tol``; ``wall``
    numbers are not compared. Returns one message per disagreement."""
    template, nums = split(derived)
    if template != entry["template"]:
        return [f"{entry['name']}: {derived!r} is not the reference's "
                f"{entry['derived']!r}"]
    bad = []
    for (name, text), f in zip(nums, entry["fields"]):
        if f["kind"] == "exact" and text != f["text"]:
            bad.append(f"{entry['name']} {name}={text}: the reference "
                       f"printed {f['text']}")
        elif (f["kind"] == "statistical"
              and abs(float(text) - float(f["text"])) > f["tol"] * (1 + 1e-9)):
            bad.append(f"{entry['name']} {name}={text}: the reference "
                       f"printed {f['text']}, tolerance {f['tol']:.6g}")
    return bad


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--emit-dir", default=None, metavar="DIR",
                    help="write BENCH_torch_*_h100.json baselines for the "
                         "gated modules into DIR")
    args = ap.parse_args(argv)
    if args.emit_dir:
        os.makedirs(args.emit_dir, exist_ok=True)
    print("name,us_per_call,derived")
    failed = []
    for name in MODULES:
        if args.only and args.only not in name:
            continue
        try:
            rows = module(name).run(device=args.device)
            for bname, us, derived in rows:
                print(f"{bname},{us},\"{derived}\"", flush=True)
            if args.emit_dir and name in BENCH_NAMES:
                path = common.emit_bench_json(
                    f"torch_{name}", rows,
                    os.path.join(args.emit_dir, BENCH_NAMES[name]))
                print(f"# wrote {path}", file=sys.stderr)
            else:
                common.drain_counters()  # never leak across modules
        except Exception:  # noqa: BLE001 — keep the suite running
            failed.append(name)
            common.drain_counters()
            print(f"{name},-1,\"FAILED: "
                  f"{traceback.format_exc().splitlines()[-1]}\"", flush=True)
    if failed:
        print(f"# {len(failed)} module(s) failed: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
