"""MAJ-N kernel: bitwise majority over N packed bit-planes.

Out bit = (number of the N planes with that bit set >= ``threshold``). In
the port it carries the reliability plane's replica vote
(``reliability/faults.py``): the majority, disagreement and weak-margin
planes over R fault-injected replicas are MAJ-R at different thresholds
(any R the retry policy escalates to). The chip model's charge-sharing APA
(``core/chip.py::majority_bits``) is MAJ over the activated data rows.
Replaces the TPU kernel ``repro/kernels/maj_n.py::maj_n``.

* :func:`maj_n_cuda` launches the hand-written CUDA kernel
  (``csrc/maj_n.cu``): a block's warps share out the N planes in row
  groups, each thread holds four words and a bit-sliced counter in
  registers and puts its plane loads in flight before its first add, and
  the groups' counters meet in shared memory. At large W it is bound by
  device-memory bytes, ``(N + 1) * W * 4``; at the chip model's W = 2048
  by latency and launch. :func:`geometry` picks the row groups and the
  column tile for each ``(N, W)``.
* :func:`maj_n_plain` is its plain PyTorch version (``ref.maj_n_fast``,
  the same counter algorithm; ``ref.maj_n`` is the bit-unpacking oracle,
  ``ref.maj_n_grouped`` the kernel's decomposition into row groups).

The dispatch between them is :func:`repro_torch.kernels.ops.maj_n`.
"""

from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from repro_torch.kernels import _build, ref

SOURCE = pathlib.Path(__file__).with_name("csrc") / "maj_n.cu"
NAME = "maj_n"
ENTRY = "maj_n_launch"
ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p)
# K = bit_length(N) counter planes, a template parameter of 1..16.
MAX_PLANES = (1 << 16) - 1
# The kernel's limits (``csrc/maj_n.cu``): words a thread holds, threads
# a block, and the shared memory of the groups' merge, 16 bytes a thread
# for each of the K counter planes and the carry-out plane.
VEC = 4
MAX_THREADS = 256
SMEM_BYTES = 48 << 10
# Planes a thread loads in one round of device-memory latency; the H100's
# 132 SMs, two blocks on each at large W; and the threads of that grid
# of full blocks, past which a thread takes more planes instead of the
# grid more row groups (at [31, 65536], 4 groups of 8 planes measured
# faster than 8 of 4: tools/maj_n_timing.py --sweep).
ROUND_PLANES = 4
SMS = 132
MIN_BLOCKS = 2 * SMS
FULL_THREADS = MIN_BLOCKS * MAX_THREADS

maj_n_plain = ref.maj_n_fast


@functools.lru_cache(maxsize=1)
def build_item() -> tuple[str, str]:
    """``(library name, source)``, the name keyed on a hash of the
    source; also the input of :func:`_build.build_many`."""
    src = SOURCE.read_text()
    return _build.source_name("maj_n", src), src


def library():
    return _build.load(*build_item(), ENTRY, ARGTYPES)


def _pow2_floor(v: int) -> int:
    return 1 << (v.bit_length() - 1)


@functools.lru_cache(maxsize=256)
def geometry(n: int, w: int) -> tuple[int, int]:
    """``(groups, tile)`` of the kernel's launch on ``[n, w]`` planes:
    ``groups`` row groups share out the planes and a block covers ``tile``
    word columns (``tile / VEC`` threads a group).

    Row groups give every thread at most :data:`ROUND_PLANES` planes (one
    latency round) as long as the grid stays under
    :data:`FULL_THREADS`; past that a thread takes more planes, in
    batches of 4. A group's width is a power of two of at most a block's
    share, cut (down to 8 threads, 32 words) until the grid has
    :data:`MIN_BLOCKS` blocks."""
    if not 1 <= n <= MAX_PLANES:
        raise ValueError(f"maj_n takes 1..{MAX_PLANES} planes, got {n}")
    if w < 0:
        raise ValueError(f"negative width {w}")
    k = n.bit_length()
    cap = MAX_THREADS
    while cap * (k + 1) * 16 > SMEM_BYTES:
        cap //= 2
    quads = max(1, -(-w // VEC))
    groups = max(1, min(-(-n // ROUND_PLANES), FULL_THREADS // quads,
                        cap))
    tpg = min(_pow2_floor(cap // groups), 1 << (quads - 1).bit_length())
    while tpg > 8 and -(-quads // tpg) < MIN_BLOCKS:
        tpg //= 2
    return groups, VEC * tpg


def maj_n_cuda(x: torch.Tensor, threshold: int) -> torch.Tensor:
    """x: contiguous [N, W] int32 CUDA tensor, N in [1, MAX_PLANES] ->
    [W] int32."""
    if not x.is_cuda:
        raise ValueError("maj_n_cuda takes a CUDA tensor")
    if x.dtype != torch.int32 or x.dim() != 2:
        raise ValueError(f"expected an [N, W] int32 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    n, w = x.shape
    if not 1 <= n <= MAX_PLANES:
        raise ValueError(f"maj_n takes 1..{MAX_PLANES} planes, got {n}")
    if not 1 <= threshold <= n:
        raise ValueError(f"threshold {threshold} not in [1,{n}]")
    if not x.is_contiguous():
        raise ValueError("maj_n_cuda takes a contiguous tensor")
    groups, tile = geometry(n, w)
    out = torch.empty(w, dtype=torch.int32, device=x.device)
    lib = library()
    with torch.cuda.device(x.device):
        rc = lib.maj_n_launch(x.data_ptr(), out.data_ptr(), n, w,
                              int(threshold), groups, tile,
                              _build.stream_of(x))
    _build.check(lib, rc, NAME)
    if w:
        _build.LAUNCHES[NAME] += 1
    return out
