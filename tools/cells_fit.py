#!/usr/bin/env python3
"""Which cuts of an architecture's launch cells fit one card.

Each ``--cell SHAPE:BATCH[:LAYERS]`` runs on its own through
``chip_smoke.run_cells`` (the cell built by ``launch.steps.build_cell``
at full width, its sequence length kept, its batch and depth cut as
given): the lines ``run_cells`` prints, or, when the card runs out of
memory, one line with the peak allocated before the failed allocation.
The next cell runs after the memory is freed. It exits 1 if any cell
failed for another reason.

Usage: ``python3 tools/cells_fit.py --arch deepseek-v2-236b
--cell train_4k:2:1 --cell train_4k:1:1``
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--cell", action="append", required=True,
                    help="SHAPE:BATCH[:LAYERS]")
    ap.add_argument("--seed", type=int, default=20231202)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("cells_fit: no CUDA card", file=sys.stderr)
        return 2
    print(f"card: {cs.nvidia_smi()}")
    failed = False
    for spec in args.cell:
        name, batch, *layers = spec.split(":")
        cut = (name, int(batch), int(layers[0]) if layers else None)
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        try:
            cs.run_cells(args.arch, (cut,), "cuda", args.seed)
        except torch.OutOfMemoryError as e:
            print(f"{args.arch} {spec}: out of the card's memory after "
                  f"{time.perf_counter() - t:.1f} s, peak allocated "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB: "
                  f"{str(e).splitlines()[0]}")
        except Exception as e:  # reported, then the next cell
            failed = True
            print(f"{args.arch} {spec}: FAILED {type(e).__name__}: {e}")
        cs._free(True)
        sys.stdout.flush()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
