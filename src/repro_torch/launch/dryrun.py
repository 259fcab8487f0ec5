"""Analytic dry run: build EVERY (architecture x input-shape) cell on the
production meshes and trace it on ``meta`` tensors.

  python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k
  python -m repro_torch.launch.dryrun --all --multi-pod --out dry.jsonl

The port's counterpart of ``repro.launch.dryrun``. The reference lowers
and compiles each cell with XLA over 512 forced host devices and reads
the compiled program: ``memory_analysis()``, ``cost_analysis()`` and a
collective census of the post-SPMD HLO. PyTorch has no compiled buffer
assignment, so the port's record keeps what traces on ``meta`` tensors
(shapes, no storage) can show:

* ``flops``: the FLOPs ``torch.utils.flop_counter.FlopCounterMode``
  counts over one call of the cell's ``fn`` (backward included for a
  train cell), divided by ``n_devices`` — per device, as the HLO's are.
  ``FlopCounterMode`` counts only matmul-class ops (matmuls, einsums,
  convolutions, attention), no elementwise op, softmax or reduction;
* ``memory.argument_size_in_bytes``: the bytes of every argument's
  per-device shape (``sharding.local_shape``) under the cell's
  ``in_shardings``;
* ``lower_compile_s``: the seconds of the ``meta`` trace;
* ``collectives`` (:func:`collective_census`, production meshes only):
  the cell traced once more as DTensors on ``meta`` tensors over the
  mesh, one rank of a ``fake`` process group of ``n_devices`` ranks in
  this process (``launch/steps.py`` ``Cell.run``: arguments placed by
  their shardings, the model's constraints acting), counting every
  collective DTensor issues on one rank: bytes by kind of each result
  (the shape the reference's census reads off each HLO instruction),
  ``total_weighted`` under :data:`COLLECTIVE_FACTOR`, and
  ``region_weighted`` 0 (the layers are a Python loop, every layer is
  traced). A cell whose DTensor trace fails keeps ``collectives: null``
  and names the failing op in ``collectives_error``.

``memory.output_size_in_bytes``, ``memory.temp_size_in_bytes``,
``memory.generated_code_size_in_bytes``, ``bytes_accessed``,
``transcendentals`` and ``hlo_bytes`` have no counterpart and are
``null``. :func:`parse_collective_bytes` stays, as text code, so the
port reads the reference's HLO and records.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import sys
import time
import traceback

from repro_torch.config.base import ARCH_IDS, LM_SHAPES, shapes_for
from repro_torch.distributed.sharding import local_shape
from repro_torch.launch.mesh import Mesh, device_mesh, make_production_mesh
from repro_torch.launch.steps import Cell, build_cell
from repro_torch.models.tree import tree_leaves, tree_map

# HLO collective ops whose operand bytes count toward the collective term.
COLLECTIVE_RE = re.compile(
    r"^\s*(?:\S+\s*=\s*)?"
    r"((?:[a-z0-9-]+)?(?:all-gather|all-reduce|reduce-scatter|all-to-all|"
    r"collective-permute)(?:-start|-done)?)"
    r"\(", re.MULTILINE)
SHAPE_RE = re.compile(r"(f32|bf16|f16|s32|u32|s8|u8|pred|s64|u64|f64)"
                      r"\[([0-9,]*)\]")

DTYPE_BYTES = {"f32": 4, "bf16": 2, "f16": 2, "s32": 4, "u32": 4, "s8": 1,
               "u8": 1, "pred": 1, "s64": 8, "u64": 8, "f64": 8}

COLLECTIVE_FACTOR = {  # per-chip wire traffic multiplier on local bytes
    "all-reduce": 2.0,          # ring AR = RS + AG
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

# Record fields the reference reads from a compiled XLA program and the
# port has no counterpart for.
NULL_FIELDS = ("bytes_accessed", "transcendentals", "hlo_bytes")
NULL_MEMORY = ("output_size_in_bytes", "temp_size_in_bytes",
               "generated_code_size_in_bytes")


def parse_collective_bytes(hlo_text: str) -> dict:
    """Sum operand bytes of every collective in the (post-SPMD, per-device)
    HLO, split by whether the instruction sits in the entry computation or
    inside a while-loop body region.

    XLA's cost_analysis (and a naive text census) counts while bodies ONCE,
    not x trip-count — every lax.scan (layer stacks, chunked attention)
    under-reports. The roofline layer multiplies the 'region' bucket by the
    cell's dominant loop trip count (the layer scan).

    Returns {kind: bytes, 'total_weighted': ..., 'region_weighted': ...}.
    """
    out: dict[str, float] = {}
    weighted = 0.0
    region_weighted = 0.0
    in_region = False
    for line in hlo_text.splitlines():
        ls = line.strip()
        # Computation block headers: scan bodies/conditions are %region_*.
        if ls.endswith("{") and (ls.startswith("%") or
                                 ls.startswith("ENTRY")):
            in_region = ls.startswith("%region")
            continue
        m = re.search(
            r"=\s*(\S+?)\s+"
            r"((?:all-gather|all-reduce|reduce-scatter|all-to-all|"
            r"collective-permute)(?:-start)?)\(", ls)
        if not m:
            continue
        shape_str, kind = m.group(1), m.group(2)
        kind_base = kind.replace("-start", "")
        nbytes = 0
        for dt, dims in SHAPE_RE.findall(shape_str):
            n = 1
            if dims:
                for d in dims.split(","):
                    if d:
                        n *= int(d)
            nbytes += n * DTYPE_BYTES[dt]
        out[kind_base] = out.get(kind_base, 0) + nbytes
        w = COLLECTIVE_FACTOR[kind_base] * nbytes
        weighted += w
        if in_region:
            region_weighted += w
    out["total_weighted"] = weighted
    out["region_weighted"] = region_weighted
    return out


def mesh_name(mesh: Mesh) -> str:
    return "x".join(str(s) for s in mesh.axis_sizes)


def argument_bytes(cell: Cell, mesh: Mesh) -> int:
    """Bytes of the cell's arguments on one device: each leaf's
    ``local_shape`` under its ``in_shardings`` entry."""
    sizes = tree_map(
        lambda x, sh: math.prod(local_shape(x.shape, sh.spec, mesh))
        * x.element_size(),
        cell.args, cell.in_shardings)
    return int(sum(tree_leaves(sizes)))


# The collectives DTensor, and the port's own sums over ranks, dispatch,
# by kind: ``torch.ops._c10d_functional``'s, and DTensor's move of a
# shard from one dim to another (``_dtensor.shard_dim_alltoall``, counted
# by its input's bytes).
FUNCOL_KINDS = {"_c10d_functional.all_reduce": "all-reduce",
                "_c10d_functional.all_gather_into_tensor": "all-gather",
                "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
                "_c10d_functional.all_to_all_single": "all-to-all",
                "_dtensor.shard_dim_alltoall": "all-to-all"}


def collective_bytes():
    """A dispatch mode (a context manager) that sums, by kind, the bytes
    of every collective dispatched inside it (each counted by its own
    op: its result's bytes, an all-to-all its input's): its ``bytes``
    dict. A CPU mesh has no all-to-all (gloo), so there DTensor moves a
    shard between dims by an all-gather and a slice, and that counts as
    the all-gather it is."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Census(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.bytes: dict[str, float] = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            kind = FUNCOL_KINDS.get(str(func.overloadpacket))
            if kind is not None:
                res = args[0] if kind == "all-to-all" else out
                self.bytes[kind] = self.bytes.get(kind, 0) + \
                    res.numel() * res.element_size()
            return out

    return Census()


def _meta_dtensor(x, sharding, dm):
    """A DTensor of ``x``'s global shape laid out by ``sharding``: rank
    0's ``meta`` shard (``local_shape``) under the placements."""
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed.sharding import placements
    local = torch.empty(local_shape(x.shape, sharding.spec, sharding.mesh),
                        dtype=x.dtype, device="meta")
    return DTensor.from_local(
        local, dm, placements(sharding.spec, sharding.mesh.axis_names,
                              sharding.mesh.axis_sizes),
        shape=x.shape, stride=x.stride())


def collective_census(cell: Cell, mesh: Mesh) -> dict:
    """The collectives one rank issues when ``cell`` runs as DTensors on
    ``mesh`` (its ``meta`` arguments placed by ``in_shardings``, outputs
    laid out by ``out_shardings``), on a ``fake`` process group of
    ``mesh.size`` ranks started and destroyed here (the process must
    have none). Returns the reference's census schema."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("collective_census: this process already has a "
                           "process group")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=mesh.size)
    try:
        dm = device_mesh(mesh, device_type="cpu")
        args = tree_map(lambda x, sh: _meta_dtensor(x, sh, dm), cell.args,
                        cell.in_shardings)
        census = collective_bytes()
        with census:
            cell.run(args, dm)
    finally:
        dist.destroy_process_group()
    out = dict(sorted(census.bytes.items()))
    out["total_weighted"] = sum(COLLECTIVE_FACTOR[k] * v
                                for k, v in census.bytes.items())
    out["region_weighted"] = 0.0
    return out


def trace_cell(cell: Cell, mesh: Mesh) -> dict:
    """The analytic record of a built cell over ``mesh``: its ``meta``
    arguments traced through ``fn`` once under ``FlopCounterMode``."""
    from torch.utils.flop_counter import FlopCounterMode

    rec = {"arch": cell.arch, "shape": cell.shape.name,
           "mesh": mesh_name(mesh), "n_devices": mesh.size}
    t0 = time.time()
    counter = FlopCounterMode(display=False)
    with counter:
        cell.fn(*cell.args)
    rec["lower_compile_s"] = round(time.time() - t0, 1)
    rec["memory"] = {"argument_size_in_bytes": argument_bytes(cell, mesh),
                     **{k: None for k in NULL_MEMORY}}
    rec["flops"] = float(counter.get_total_flops()) / mesh.size
    rec.update({k: None for k in NULL_FIELDS})
    rec["collectives"] = None
    return rec


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             overrides: dict | None = None) -> dict:
    """The record of one cell on a production mesh: :func:`trace_cell`,
    then its :func:`collective_census` (``null``, with the failing op in
    ``collectives_error``, when the DTensor trace fails)."""
    shape = LM_SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    cell = build_cell(arch, shape, mesh, overrides=overrides)
    rec = trace_cell(cell, mesh)
    t0 = time.time()
    try:
        rec["collectives"] = collective_census(cell, mesh)
    except Exception as e:  # noqa: BLE001 — record the op, keep the cell
        rec["collectives_error"] = f"{type(e).__name__}: {e}"[:500]
    rec["census_s"] = round(time.time() - t0, 1)
    return rec


def _fmt(x) -> str:
    return "-" if x is None else f"{x:.3e}"


def _run_one_inline(arch: str, sname: str, multi_pod: bool,
                    out: str | None) -> dict:
    tag = f"{arch} x {sname} x {'2x16x16' if multi_pod else '16x16'}"
    try:
        rec = run_cell(arch, sname, multi_pod)
        rec["status"] = "ok"
        print(f"[dryrun] OK   {tag}: flops={rec['flops']:.3e} "
              f"argbytes={_fmt(rec['memory']['argument_size_in_bytes'])} "
              f"temp={_fmt(rec['memory']['temp_size_in_bytes'])} "
              f"coll={_fmt((rec['collectives'] or {}).get('total_weighted'))}"
              f" ({rec['lower_compile_s']}s + census "
              f"{rec['census_s']}s)", flush=True)
    except Exception as e:  # noqa: BLE001 — report, keep sweeping
        rec = {"arch": arch, "shape": sname,
               "mesh": "2x16x16" if multi_pod else "16x16",
               "status": "fail", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-2000:]}
        print(f"[dryrun] FAIL {tag}: {rec['error']}", flush=True)
    if out:
        with open(out, "a") as f:
            f.write(json.dumps(rec) + "\n")
    return rec


def _run_one_subprocess(arch: str, sname: str, multi_pod: bool, out: str,
                        timeout_s: int) -> dict:
    """Per-cell worker-process isolation: one OOM-killed or hung trace
    can't take down the sweep (same supervision posture as the trainer)."""
    import subprocess
    import sys
    tag = f"{arch} x {sname} x {'2x16x16' if multi_pod else '16x16'}"
    argv = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
            arch, "--shape", sname, "--out", out]
    if multi_pod:
        argv.append("--multi-pod")
    try:
        proc = subprocess.run(argv, timeout=timeout_s,
                              capture_output=True, text=True)
        if proc.returncode == 0:
            for line in proc.stdout.splitlines():
                if line.startswith("[dryrun] OK") or \
                        line.startswith("[dryrun] FAIL"):
                    print(line, flush=True)
            return {"status": "ok"}
        err = {"arch": arch, "shape": sname,
               "mesh": "2x16x16" if multi_pod else "16x16",
               "status": "fail",
               "error": f"worker exit {proc.returncode} "
                        f"(OOM-killed?): {proc.stdout[-300:]}"}
    except subprocess.TimeoutExpired:
        err = {"arch": arch, "shape": sname,
               "mesh": "2x16x16" if multi_pod else "16x16",
               "status": "fail", "error": f"timeout after {timeout_s}s"}
    print(f"[dryrun] FAIL {tag}: {err['error'][:160]}", flush=True)
    with open(out, "a") as f:
        f.write(json.dumps(err) + "\n")
    return err


def _done_cells(out: str | None) -> set:
    done = set()
    if out and os.path.exists(out):
        with open(out) as f:
            for line in f:
                r = json.loads(line)
                if r.get("status") == "ok":
                    done.add((r["arch"], r["shape"], r["mesh"]))
    return done


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(LM_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None, help="JSONL output path")
    ap.add_argument("--isolate", action="store_true",
                    help="one worker subprocess per cell + resume")
    ap.add_argument("--cell-timeout", type=int, default=3600)
    args = ap.parse_args(argv)

    cells: list[tuple[str, str]] = []
    if args.all:
        for arch in ARCH_IDS:
            for sname in shapes_for(arch):
                cells.append((arch, sname))
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape (or --all) required")
        cells = [(args.arch, args.shape)]

    meshes = [args.multi_pod]
    if args.both_meshes:
        meshes = [False, True]

    done = _done_cells(args.out) if args.isolate else set()
    results = []
    for multi_pod in meshes:
        mname = "2x16x16" if multi_pod else "16x16"
        for arch, sname in cells:
            if (arch, sname, mname) in done:
                print(f"[dryrun] SKIP {arch} x {sname} x {mname} "
                      f"(already ok)", flush=True)
                continue
            if args.isolate:
                rec = _run_one_subprocess(arch, sname, multi_pod, args.out,
                                          args.cell_timeout)
            else:
                rec = _run_one_inline(arch, sname, multi_pod, args.out)
            results.append(rec)
    n_ok = sum(r["status"] == "ok" for r in results)
    print(f"[dryrun] {n_ok}/{len(results)} cells traced "
          f"({len(done)} skipped as done)")
    if n_ok < len(results):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
