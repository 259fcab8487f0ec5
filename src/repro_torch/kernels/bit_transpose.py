"""Bit-transpose kernel: 32x32 bit-matrix transpose of G tiles.

Horizontal (one 32-bit word per element) <-> vertical (bit-planes along
the lane axis) conversion runs at both ends of every fused flush
(``PlaneLayout.pack_planes``/``unpack_planes``). Replaces the TPU kernel
``repro/kernels/bit_transpose.py::bit_transpose32``.

* :func:`bit_transpose32_cuda` launches the hand-written CUDA kernel
  (``csrc/bit_transpose.cu``, one thread per tile, the swap network in
  registers). It is bound by device-memory bytes: 256 bytes per tile.
* :func:`bit_transpose32_plain` is its plain PyTorch version
  (``ref.bit_transpose32``).

The dispatch between them is :func:`repro_torch.kernels.ops.bit_transpose32`.
"""

from __future__ import annotations

import functools
import pathlib

import torch

from repro_torch.kernels import _build, ref

SOURCE = pathlib.Path(__file__).with_name("csrc") / "bit_transpose.cu"
NAME = "bit_transpose32"

bit_transpose32_plain = ref.bit_transpose32


@functools.lru_cache(maxsize=1)
def build_item() -> tuple[str, str]:
    """``(library name, source)``, the name keyed on a hash of the
    source; also the input of :func:`_build.build_many`."""
    src = SOURCE.read_text()
    return _build.source_name("bit_transpose", src), src


def bit_transpose32_cuda(x: torch.Tensor) -> torch.Tensor:
    """x: contiguous [32, G] int32 CUDA tensor -> its tile-wise transpose."""
    if not x.is_cuda:
        raise ValueError("bit_transpose32_cuda takes a CUDA tensor")
    if x.dtype != torch.int32 or x.dim() != 2 or x.shape[0] != 32:
        raise ValueError(f"expected a [32, G] int32 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("bit_transpose32_cuda takes a contiguous tensor")
    out = torch.empty_like(x)
    name, src = build_item()
    lib = _build.load(name, src, "bit_transpose32_launch")
    with torch.cuda.device(x.device):
        rc = lib.bit_transpose32_launch(x.data_ptr(), out.data_ptr(),
                                        x.shape[1], _build.stream_of(x))
    _build.check(lib, rc, NAME)
    if x.shape[1]:
        _build.LAUNCHES[NAME] += 1
    return out
