"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's configuration, its own file, its traffic and its driver are
found by name (``perfbench/__init__.py``). With ``--trace 0`` the line
carries the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics and the traced stretch's device busy time and breakdown. Every
run ends with the comparison against the plain reference that decides
``correct``; its numbers and limits are the last lines on standard error
and the last key of the result line.

Exits with another code than 0, printing no result, when no CUDA card
(or fewer than the cell asks for) is there, when the program is not in
the checkout, or when JAX or the JAX package was loaded."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse
import importlib
import importlib.util
import json
import os
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def fail(msg: str, code: int) -> None:
    print(f"perfbench: {msg}", file=sys.stderr)
    sys.exit(code)


def metric_reader(name: str):
    path = ROOT / "perfbench" / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"perfbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics this cell reports: end-to-end with ``--trace 0``,
    per-layer with ``--trace 1``; a metric without ``workloads`` is in
    every cell that reports the end-to-end metric it moves."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in moved
                             else [])]


def loaded_forbidden() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch").is_dir():
        fail("the program (src/repro_torch) is not in this checkout", 2)
    # Build and kernel caches at fixed places inside the checkout (the
    # port's own nvcc builds go to build/repro_torch/ by itself).
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)

    import torch
    from perfbench import checks, spec

    bench = spec.benchmark()
    cell = spec.cell(args.workload, bench)
    chips = cell["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        fail(f"needs {chips} CUDA card(s); found "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
             3)
    driver = importlib.import_module(
        f"perfbench.drivers.{cell['workload']['driver']}")
    torch.cuda.reset_peak_memory_stats()
    rec = driver.run(cell, args.seed, args.seconds, bool(args.trace),
                     "cuda", T_START)
    rec["kind"] = cell["workload"]["driver"]

    bad = loaded_forbidden()
    if bad:
        fail(f"the run loaded {', '.join(bad)}", 4)

    metrics = {}
    for m in cell_metrics(bench, args.workload, bool(args.trace)):
        v = metric_reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": rec["memory_peak_bytes"]}
    out = {"correct": checks.passed(rec["checks"]),
           "attempted": rec["attempted"], "failed": rec["failed"],
           "metrics": metrics, "device": device}
    if args.trace and rec["trace"]:
        device["busy_s"] = rec["trace"]["busy_s"]
        device["window_s"] = rec["trace"]["window_s"]
        out["breakdown"] = {"device_ops": rec["trace"]["device_ops"],
                            "idle_gaps": rec["trace"]["idle_gaps"]}
    out["checks"] = rec["checks"]
    checks.print_checks(rec["checks"], rec.get("notes"))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
