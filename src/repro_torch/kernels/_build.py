"""Build, load and launch support for the port's hand-written CUDA kernels.

Each kernel source is compiled on first use with ``nvcc`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds) and loaded with ``ctypes``::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/repro_torch/<name>.so <name>.cu

Libraries land in ``build/repro_torch/`` at the root of the checkout
(listed in ``.gitignore``), named by a hash of their source, so an edited
source or generator can never be served a stale library. Every C entry
point takes its pointers and the CUDA stream as ``void*`` and returns
``cudaGetLastError()``; :func:`check` raises when it is not 0 — a launch
the card refuses never runs, and ``torch.cuda.synchronize()`` would not
report it.

Nothing here runs at import: the CPU tests import every module, and this
host may have no toolkit at all.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import pathlib
import re
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor

BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Launch counts per kernel: each wrapper adds one where it launches its
# kernel, and nowhere else.
LAUNCHES: collections.Counter = collections.Counter()
# name -> {"seconds": nvcc wall time (0.0 when the library was already
# built), "ptxas": the -Xptxas -v report}
BUILDS: dict[str, dict] = {}

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def source_name(prefix: str, *texts: str) -> str:
    """``prefix`` plus a hash of ``texts`` (a source, or a generator's
    own source and its input): the library's file name."""
    h = hashlib.sha256()
    for t in texts:
        h.update(t.encode())
        h.update(b"\0")
    return f"{prefix}_{h.hexdigest()[:16]}"


def nvcc() -> str:
    path = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if not path.exists():
        raise RuntimeError(
            f"nvcc not found at {path}: the port's CUDA kernels build only "
            f"on a host with the CUDA toolkit (set CUDA_HOME)")
    return str(path)


def compile_source(name: str, source: str) -> pathlib.Path:
    """Compile ``source`` to ``BUILD_DIR/<name>.so`` unless it exists."""
    so = BUILD_DIR / f"{name}.so"
    if so.exists():
        BUILDS.setdefault(name, {"seconds": 0.0, "ptxas": ""})
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Each build writes its own source and output files and renames them
    # into place, so two threads or processes may build one name at once.
    tag = f"{os.getpid()}.{threading.get_ident()}"
    cu = BUILD_DIR / f"{name}.{tag}.cu"
    cu.write_text(source)
    tmp = BUILD_DIR / f"{name}.{tag}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {cu}:\n{proc.stderr[-4000:]}")
    os.replace(tmp, so)
    os.replace(cu, BUILD_DIR / f"{name}.cu")
    BUILDS[name] = {"seconds": time.perf_counter() - t0,
                    "ptxas": proc.stderr + proc.stdout}
    return so


def build_many(items) -> None:
    """Compile several ``(name, source)`` pairs at once, one ``nvcc``
    each, all started together."""
    items = [(n, s) for n, s in items if not (BUILD_DIR / f"{n}.so").exists()]
    if not items:
        return
    with ThreadPoolExecutor(max_workers=len(items)) as ex:
        for f in [ex.submit(compile_source, n, s) for n, s in items]:
            f.result()


LAUNCH_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_void_p)


def load(name: str, source: str, entry: str,
         argtypes=LAUNCH_ARGTYPES) -> ctypes.CDLL:
    """The loaded library for ``source`` (built on first use), with its
    launch ``entry`` typed by ``argtypes`` (default ``int entry(void*,
    void*, long long, void*)``) and returning ``int``."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(compile_source(name, source)))
            fn = getattr(lib, entry)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            lib.error_string.argtypes = [ctypes.c_int]
            lib.error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} "
                           f"({lib.error_string(rc).decode()})")


def ptxas_summary(name: str) -> str:
    """Registers and spill bytes from a build's ``-Xptxas -v`` report."""
    rep = BUILDS.get(name, {}).get("ptxas", "")
    regs = re.findall(r"Used (\d+) registers", rep)
    spills = re.findall(r"(\d+) bytes spill stores", rep)
    return (f"registers={','.join(regs) or '?'} "
            f"spill_store_bytes={','.join(spills) or '?'}")


def stream_of(x) -> int:
    """The raw handle of PyTorch's current stream on ``x``'s device."""
    import torch
    return torch.cuda.current_stream(x.device).cuda_stream
