"""The readings that the limits of ``correct`` are set from, on the card
at a cell's own size; the benchmark's runs do not run this.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 [--program-seeds 4,5,...] [--seconds S]

For each of ``--seeds``: the program's sound reading (as a run makes it),
the control's (the reference in the program's place, in float8 e4m3, the
step below the bfloat16 the configuration states) and each fault the
cell can have, planted in the reference put in the program's place:

* training: half of each batch left out, the mean over the rest, in the
  reference put in the program's place; AdamW without weight decay, and
  with beta2 0.999, planted in the program (``update_gap`` alone); a step
  that returns its state unchanged reads 1 by the measure and needs no
  run;
* serving: a served token altered where it is produced (the token the
  reference ranks last at one position, and the reference's second best
  at another).

``--program-seeds`` adds sound readings alone. One JSON line a reading
goes to standard output and to ``<--out>/control-<cell>.jsonl``."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse
import copy
import json
import os
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def emit(out, **row) -> None:
    line = json.dumps(row)
    print(line, flush=True)
    out.write(line + "\n")
    out.flush()


# Optimizer faults planted in the program: it runs with a setting other
# than the one the cell states, and ``update_gap`` is read against the
# stated one.
OPTIMIZER_FAULTS = {"fault_no_weight_decay": {"weight_decay": 0.0},
                    "fault_beta2": {"beta2": 0.999}}


def program_readings(cell, seed, device, optimizer=None):
    """The program's set-up readings and ``update_gap`` against the
    cell's stated AdamW; ``optimizer`` plants other settings."""
    import torch
    from perfbench.drivers import train
    run_cell = copy.deepcopy(cell)
    run_cell["workload"]["train"]["optimizer"].update(optimizer or {})
    state, prog, _ = train.program(run_cell, seed, device)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    state.clear()
    train.free()
    gap, at = train.update_check(cell, seed, prog, device)
    prog.pop("after"), prog.pop("nu")
    return prog, {"update_gap": gap, "update_worst_leaf": at,
                  "memory_peak_bytes": peak}


def train_readings(cell, seed, device, control: bool, out) -> None:
    from perfbench.drivers import train
    prog, upd = program_readings(cell, seed, device)
    t0 = time.perf_counter()
    ref = train.reference(cell, seed, device)
    t_ref = time.perf_counter() - t0
    emit(out, seed=seed, what="program", reference_s=t_ref, **upd,
         **train.compare(prog, ref))
    del prog
    if not control:
        return
    lower = train.reference(cell, seed, device, precision="fp8")
    emit(out, seed=seed, what="control_fp8", **train.compare(lower, ref))
    del lower
    b = cell["traffic"]["seqs_per_step"]
    half = train.reference(cell, seed, device, rows=slice(0, b // 2))
    emit(out, seed=seed, what="fault_half_batch", **train.compare(half, ref))
    del half, ref
    train.free()
    for name, change in OPTIMIZER_FAULTS.items():
        bad, upd = program_readings(cell, seed, device, change)
        del bad
        emit(out, seed=seed, what=name, **upd)
        train.free()


def serve_readings(cell, seed, seconds, device, control: bool, out) -> None:
    import numpy as np
    import torch
    from perfbench import spec
    from perfbench.drivers import serve, train
    rec = serve.run(cell, seed, seconds, False, device, time.perf_counter(),
                    keep=True)
    kept = rec.pop("kept")
    emit(out, seed=seed, what="program", checks=rec["checks"],
         notes=rec["notes"], memory_peak_bytes=rec.get("memory_peak_bytes"))
    if control:
        a = spec.arch(cell["config"])
        logits, picked = kept["logits"], kept["picked"]
        low = serve.ref_logits(a, kept["params"], picked, device, "fp8")
        firsts = [lg.argmax(dim=1).cpu().numpy() for lg in low]
        emit(out, seed=seed, what="control_fp8",
             logit_gap=serve.gaps_of(logits, firsts),
             changed_firsts=int(sum((f != np.asarray(r.out_tokens)).sum()
                                    for f, r in zip(firsts, picked))))
        lg0 = logits[0]
        altered = [list(r.out_tokens) for r in picked]
        altered[0][-1] = int(lg0[-1].argmin())
        emit(out, seed=seed, what="fault_token_lowest",
             logit_gap=serve.gaps_of(logits, altered))
        altered = [list(r.out_tokens) for r in picked]
        second = torch.topk(lg0[0], 2).indices[1]
        altered[0][0] = int(second)
        emit(out, seed=seed, what="fault_token_second",
             logit_gap=serve.gaps_of(logits, altered))
    del kept
    train.free()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--program-seeds", default="")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=str(ROOT / "build" / "perfbench"))
    args = ap.parse_args(argv)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    # One process reads many seeds: keep the allocator from fragmenting
    # across them (the benchmark's runs are one process each).
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch
    from perfbench import spec
    if args.device == "cuda" and not torch.cuda.is_available():
        print("perfbench control: no CUDA card", file=sys.stderr)
        return 3
    cell = spec.cell(args.workload)
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    seeds = [(int(s), True) for s in args.seeds.split(",") if s] + \
        [(int(s), False) for s in args.program_seeds.split(",") if s]
    with open(out_dir / f"control-{args.workload}.jsonl", "a") as out:
        for seed, control in seeds:
            t0 = time.perf_counter()
            if cell["workload"]["driver"] == "train":
                train_readings(cell, seed, args.device, control, out)
            else:
                serve_readings(cell, seed, args.seconds, args.device,
                               control, out)
            emit(out, seed=seed, what="seconds",
                 value=time.perf_counter() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
