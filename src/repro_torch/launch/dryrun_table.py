"""Render the dry-run table from sweep JSONL records.

The port's copy of ``repro.launch.dryrun_table``. It reads the port's
records and the reference's alike; a field the port's analytic dry run
leaves ``null`` (temp bytes, the collective census) prints as ``-``.
"""

from __future__ import annotations

import argparse
import json


def fmt_b(x: float | None) -> str:
    if x is None:
        return "-"
    for unit, div in (("GB", 1e9), ("MB", 1e6), ("KB", 1e3)):
        if x >= div:
            return f"{x/div:.1f} {unit}"
    return f"{x:.0f} B"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("records", nargs="+")
    ap.add_argument("--md", default=None)
    args = ap.parse_args(argv)
    rows = []
    for path in args.records:
        with open(path) as f:
            rows.extend(json.loads(l) for l in f)
    lines = [
        "| arch | shape | mesh | compile | args/dev | temp/dev | "
        "HLO GFLOP/dev | collective/dev | status |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        if r.get("status") != "ok":
            lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} "
                         f"| - | - | - | - | - | FAIL: {r['error'][:40]} |")
            continue
        m = r["memory"]
        coll = r.get("collectives")
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['lower_compile_s']:.0f}s "
            f"| {fmt_b(m['argument_size_in_bytes'])} "
            f"| {fmt_b(m.get('temp_size_in_bytes'))} "
            f"| {r['flops']/1e9:.1f} "
            f"| {fmt_b(coll['total_weighted'] if coll else None)} | ok |")
    md = "\n".join(lines)
    print(md)
    if args.md:
        with open(args.md, "w") as f:
            f.write(md + "\n")


if __name__ == "__main__":
    main()
