"""Bit-serial add kernel: vertical-layout ripple-carry add of plane stacks.

a, b ``[width, W]`` int32 bit-planes -> ``[width, W]`` sum planes modulo
``2**width``, carry = MAJ3(a, b, carry). It is the full-adder loop of the
chip model's bit-serial ALU (``core/alu.py::BitSerialAlu.add``) fused into
one pass; the ALU itself keeps issuing its MAJ command programs (its
``OpStats`` are the reference's), and this kernel is the public
``repro_torch.kernels.bitserial_add``. Replaces the TPU kernel
``repro/kernels/bitserial_add.py::bitserial_add``.

* :func:`bitserial_add_cuda` launches the hand-written CUDA kernel
  (``csrc/bitserial_add.cu``, one thread per word, the carry in a
  register). It is bound by device-memory bytes: ``3 * width * W * 4``.
* :func:`bitserial_add_plain` is its plain PyTorch version
  (``ref.bitserial_add``).

The dispatch between them is :func:`repro_torch.kernels.ops.bitserial_add`.
"""

from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from repro_torch.kernels import _build, ref

SOURCE = pathlib.Path(__file__).with_name("csrc") / "bitserial_add.cu"
NAME = "bitserial_add"
ENTRY = "bitserial_add_launch"
ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_void_p)

bitserial_add_plain = ref.bitserial_add


@functools.lru_cache(maxsize=1)
def build_item() -> tuple[str, str]:
    """``(library name, source)``, the name keyed on a hash of the
    source; also the input of :func:`_build.build_many`."""
    src = SOURCE.read_text()
    return _build.source_name("bitserial_add", src), src


def library():
    return _build.load(*build_item(), ENTRY, ARGTYPES)


def bitserial_add_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: contiguous [width, W] int32 CUDA tensors on one device, width
    >= 1 -> [width, W] int32 sum planes."""
    if not (a.is_cuda and b.is_cuda):
        raise ValueError("bitserial_add_cuda takes CUDA tensors")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if a.dtype != torch.int32 or b.dtype != torch.int32 or a.dim() != 2:
        raise ValueError(f"expected [width, W] int32 tensors, got "
                         f"{tuple(a.shape)} {a.dtype}, {b.dtype}")
    if a.shape != b.shape:
        raise ValueError("shape mismatch")
    width, w = a.shape
    if width < 1:
        raise ValueError("bitserial_add takes at least one plane")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("bitserial_add_cuda takes contiguous tensors")
    out = torch.empty_like(a)
    lib = library()
    with torch.cuda.device(a.device):
        rc = lib.bitserial_add_launch(a.data_ptr(), b.data_ptr(),
                                      out.data_ptr(), width, w,
                                      _build.stream_of(a))
    _build.check(lib, rc, NAME)
    if w:
        _build.LAUNCHES[NAME] += 1
    return out
