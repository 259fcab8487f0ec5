"""MAJ-N kernel: bitwise majority over N packed bit-planes.

Out bit = (number of the N planes with that bit set >= ``threshold``). In
the port it carries the reliability plane's replica vote
(``reliability/faults.py``): the majority, disagreement and weak-margin
planes over R fault-injected replicas are MAJ-R at different thresholds
(any R the retry policy escalates to). The chip model's charge-sharing APA
(``core/chip.py::majority_bits``) is MAJ over the activated data rows.
Replaces the TPU kernel ``repro/kernels/maj_n.py::maj_n``.

* :func:`maj_n_cuda` launches the hand-written CUDA kernel
  (``csrc/maj_n.cu``, one thread per word, the bit-sliced counter in
  registers). It is bound by device-memory bytes: ``(N + 1) * W * 4``.
* :func:`maj_n_plain` is its plain PyTorch version (``ref.maj_n_fast``,
  the same counter algorithm; ``ref.maj_n`` is the bit-unpacking oracle).

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
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p)
# K = bit_length(N) counter planes, a template parameter of 1..16.
MAX_PLANES = (1 << 16) - 1

maj_n_plain = ref.maj_n_fast


@functools.lru_cache(maxsize=1)
def build_item() -> tuple[str, str]:
    """``(library name, source)``, the name keyed on a hash of the
    source; also the input of :func:`_build.build_many`."""
    src = SOURCE.read_text()
    return _build.source_name("maj_n", src), src


def library():
    return _build.load(*build_item(), ENTRY, ARGTYPES)


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
    out = torch.empty(w, dtype=torch.int32, device=x.device)
    lib = library()
    with torch.cuda.device(x.device):
        rc = lib.maj_n_launch(x.data_ptr(), out.data_ptr(), n, w,
                              int(threshold), _build.stream_of(x))
    _build.check(lib, rc, NAME)
    if w:
        _build.LAUNCHES[NAME] += 1
    return out
