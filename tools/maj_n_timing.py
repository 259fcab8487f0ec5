#!/usr/bin/env python3
"""Device time of the MAJ-N kernel (K3) at its main-path shapes.

Each shape is timed with ``benchmarks/torch_kernel_bench.py::device_us``
(CUDA events around raw launches queued behind ``torch.cuda._sleep``,
inputs rotated past 128 MiB) and printed beside its bound (the larger of
``(N + 1) * W * 4`` bytes over 3.35 TB/s and ``W * N * (3K + 1)`` 32-bit
operations over 67 T/s) and three floors: a ``copy_`` that moves the
bytes of ``[31, 65536]`` (4 MiB read, 4 MiB written), one that moves
those of ``[3, 2M]`` (16 MiB and 16 MiB), and an empty kernel launched
with the grid that K3 takes at ``[31, 2048]``. Every launch is
first held bit-exact against ``ref.maj_n_fast``.

    python3 tools/maj_n_timing.py [--parent OLD/maj_n.cu] [--batch B]
                                  [--sweep]

``--parent`` builds an earlier ``maj_n.cu`` with the one-thread-a-word
interface ``maj_n_launch(x, out, n, w, threshold, stream)``, and each
``--batch B`` this tree's kernel with B plane loads a batch, into
temporary directories; each is timed in turns with the kernel of this
tree (others, this, this, others reversed). ``--sweep`` also times every
valid ``(groups, tile)`` at each shape beside ``maj_n.geometry``'s
choice.
Needs a CUDA card and ``nvcc``; prints one JSON object a line and exits
1 if a launch disagrees with its plain version.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
ALU_OPS_PER_S = 67e12       # H100 SXM 32-bit non-tensor peak

# (name, N, W, threshold): kernel_bench's MAJ-31 row, the 3-replica vote
# of a 2M-lane wire, and the chip model's votes over a PAPER_MODULE row.
SHAPES = (("kernel_bench", 31, 1 << 16, 16),
          ("replica_vote", 3, 1 << 21, 2),
          ("chip", 3, 2048, 2),
          ("chip", 7, 2048, 4),
          ("chip", 15, 2048, 8),
          ("chip", 31, 2048, 16))

EMPTY_SOURCE = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(unsigned blocks, unsigned tpg, unsigned groups,
                            void* stream) {
  empty_kernel<<<blocks, dim3(tpg, groups), 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
"""
EMPTY_ARGTYPES = (ctypes.c_uint, ctypes.c_uint, ctypes.c_uint,
                  ctypes.c_void_p)


def empty_item() -> tuple[str, str]:
    """``(library name, source)`` of the empty kernel, for
    ``_build.build_many``."""
    from repro_torch.kernels import _build
    return _build.source_name("empty", EMPTY_SOURCE), EMPTY_SOURCE


def bound_ms(n: int, w: int) -> tuple[float, str]:
    """The least time of MAJ-N on ``[n, w]`` planes, and what sets it."""
    by_bytes = (n + 1) * w * 4 / HBM_BYTES_PER_S * 1e3
    by_ops = w * n * (3 * n.bit_length() + 1) / ALU_OPS_PER_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops \
        else "operations"


def planes(n: int, w: int, seed: int):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randint(-2**31, 2**31 - 1, (n, w), dtype=torch.int32,
                      device="cuda", generator=g)
    x[:, :7] = -1
    return x


def launcher(lib, n: int, w: int, t: int, geometry=None):
    """``f(x, out)``: one raw launch of a K3 library on ``[n, w]`` planes
    at threshold ``t``; the new interface when ``geometry`` is given."""
    from repro_torch.kernels import _build
    import torch
    stream = torch.cuda.current_stream().cuda_stream
    extra = tuple(geometry) if geometry is not None else ()

    def f(x, out):
        _build.check(lib, lib.maj_n_launch(x.data_ptr(), out.data_ptr(), n,
                                           w, t, *extra, stream), "maj_n")
    return f


def timed_us(f, n: int, w: int, t: int, seed: int, repeat: int = 3
             ) -> float:
    """Device µs a launch of ``f`` on seeded ``[n, w]`` planes, after
    holding one launch bit-exact against ``ref.maj_n_fast``."""
    import torch
    from benchmarks.torch_kernel_bench import device_us
    from repro_torch.kernels import ref
    x = planes(n, w, seed)
    out = torch.empty(w, dtype=torch.int32, device="cuda")
    f(x, out)
    if not torch.equal(out, ref.maj_n_fast(x, t)):
        raise RuntimeError(f"maj_n disagrees with ref.maj_n_fast at "
                           f"[{n}, {w}] threshold {t}")
    return device_us(f, (x, out), repeat)


def floors_us(empty_lib) -> dict:
    """``copy_us``: ``copy_`` of 4 MiB into 4 MiB (the bytes of ``[31,
    65536]``); ``copy_vote_us``: of 16 MiB into 16 MiB (those of ``[3,
    2M]``); ``empty_us``: an empty kernel with K3's grid at ``[31,
    2048]`` (inputs of that size rotated, so its launches queue as K3's
    do)."""
    import torch
    from benchmarks.torch_kernel_bench import device_us
    from repro_torch.kernels import _build, maj_n

    def copy_us(words):
        src = torch.empty(words, dtype=torch.int32, device="cuda")
        return device_us(lambda s, d: d.copy_(s),
                         (src, torch.empty_like(src)), 3)
    groups, tile = maj_n.geometry(31, 2048)
    blocks = -(-2048 // tile)
    stream = torch.cuda.current_stream().cuda_stream

    def empty(x, out):
        _build.check(empty_lib, empty_lib.empty_launch(
            blocks, tile // maj_n.VEC, groups, stream), "empty")
    x = planes(31, 2048, 0)
    empty_us = device_us(empty, (x, torch.empty(2048, dtype=torch.int32,
                                                device="cuda")), 3)
    return {"copy_us": copy_us(1 << 20), "copy_vote_us": copy_us(1 << 22),
            "empty_us": empty_us,
            "empty_grid": [blocks, tile // maj_n.VEC, groups]}


def measure(lib, empty_lib, seed: int = 0) -> list[dict]:
    """One record a shape of :data:`SHAPES` for the kernel ``lib`` of this
    tree: µs, bound, share; the floors as the last record."""
    from repro_torch.kernels import maj_n
    recs = []
    for name, n, w, t in SHAPES:
        g = maj_n.geometry(n, w)
        us = timed_us(launcher(lib, n, w, t, g), n, w, t, seed)
        b, by = bound_ms(n, w)
        recs.append({"shape": [n, w], "what": name, "threshold": t,
                     "geometry": list(g), "us": us, "bound_us": b * 1e3,
                     "bound_by": by, "share": b * 1e3 / us})
    recs.append(floors_us(empty_lib))
    return recs


def build_temp(source: str, name: str, argtypes):
    """``source`` built with ``_build``'s flags into a temporary directory
    outside the checkout and loaded; prints its ``-Xptxas -v`` registers
    and spills."""
    import re
    from repro_torch.kernels import _build
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="maj_n_"))
    (tmp / f"{name}.cu").write_text(source)
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(tmp / f"{name}.so"), str(tmp / f"{name}.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr[-4000:]}")
    print(json.dumps({"build": name, "registers": [
        int(r) for r in re.findall(r"Used (\d+) registers", proc.stderr)],
        "spill_store_bytes": [int(b) for b in re.findall(
            r"(\d+) bytes spill stores", proc.stderr)]}), flush=True)
    lib = ctypes.CDLL(str(tmp / f"{name}.so"))
    lib.maj_n_launch.argtypes = list(argtypes)
    lib.maj_n_launch.restype = ctypes.c_int
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    return lib


PARENT_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p)


def batch_variant(batch: int) -> str:
    """This tree's ``maj_n.cu`` with ``batch`` plane loads a batch."""
    from repro_torch.kernels import maj_n
    src = maj_n.SOURCE.read_text()
    line = next(ln for ln in src.splitlines()
                if ln.startswith("constexpr int BATCH = "))
    return src.replace(line, f"constexpr int BATCH = {batch};")


def candidates(n: int, w: int):
    """Every ``(groups, tile)`` the kernel takes at ``[n, w]`` with groups
    a power of two or ``ceil(n / 4)`` and the tile a power of two."""
    from repro_torch.kernels import maj_n
    k = n.bit_length()
    groups = sorted({g for g in (1, 2, 4, 8, 16, 32, -(-n // 4))
                     if g <= n})
    for g in groups:
        for tile in (8, 16, 32, 64, 128, 256, 512, 1024):
            tpg = tile // maj_n.VEC
            if tpg * g <= maj_n.MAX_THREADS and (
                    g == 1 or g * (k + 1) * tpg * 16 <= maj_n.SMEM_BYTES) \
                    and tile <= 4 * max(w, 4):
                yield g, tile


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=pathlib.Path)
    ap.add_argument("--batch", type=int, action="append", default=[])
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    if not torch.cuda.is_available():
        print("maj_n_timing: no CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, maj_n
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"card": card}))
    lib = maj_n.library()
    empty_lib = _build.load(*empty_item(), "empty_launch", EMPTY_ARGTYPES)
    print(f"ptxas {maj_n.build_item()[0]}: "
          f"{_build.ptxas_summary(maj_n.build_item()[0])}")
    # name -> (library, whether it takes the geometry)
    others = {}
    if args.parent:
        others["parent"] = (build_temp(args.parent.read_text(), "parent",
                                       PARENT_ARGTYPES), False)
    for b in args.batch:
        others[f"batch{b}"] = (build_temp(batch_variant(b), f"batch{b}",
                                          maj_n.ARGTYPES), True)
    if not others:
        for rec in measure(lib, empty_lib):
            print(json.dumps(rec), flush=True)
    else:
        turns = list(others) + ["this", "this"] + list(reversed(others))
        libs = {"this": (lib, True), **others}
        for name, n, w, t in SHAPES:
            g = maj_n.geometry(n, w)
            us = {who: [] for who in libs}
            for who in turns:
                kl, new = libs[who]
                us[who].append(timed_us(launcher(kl, n, w, t,
                                                 g if new else None),
                                        n, w, t, seed=n))
            b, by = bound_ms(n, w)
            print(json.dumps({"shape": [n, w], "what": name,
                              "threshold": t, "geometry": list(g),
                              **{f"{who}_us": v for who, v in us.items()},
                              "bound_us": b * 1e3, "bound_by": by}),
                  flush=True)
        print(json.dumps(floors_us(empty_lib)), flush=True)
    if args.sweep:
        for name, n, w, t in SHAPES:
            best = None
            for g, tile in candidates(n, w):
                us = timed_us(launcher(lib, n, w, t, (g, tile)), n, w, t,
                              seed=n, repeat=2)
                print(json.dumps({"sweep": [n, w], "groups": g,
                                  "tile": tile, "us": us}), flush=True)
                best = min(best or (us, g, tile), (us, g, tile))
            print(json.dumps({"sweep_best": [n, w], "us": best[0],
                              "groups": best[1], "tile": best[2],
                              "chosen": list(maj_n.geometry(n, w))}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
