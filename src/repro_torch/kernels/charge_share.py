"""Charge-sharing kernel: the bitline deviation of the analog Monte-Carlo.

``dV = sum_i C_i (V_i - VDD/2) / (C_bl + sum_i C_i)`` per bitline, for P
input patterns over the same cell capacitances. It is the inner loop of
``core/analog.py`` (``bitline_deviation``), and so of the Monte-Carlo
success rates and of ``reliability.calibrate()``. Replaces the TPU kernel
``repro/kernels/charge_share.py::charge_share``.

* :func:`charge_share_cuda` launches the hand-written CUDA kernel
  (``csrc/charge_share.cu``, one thread per (pattern, bitline), both sums
  in registers). It is bound by device-memory bytes:
  ``(P*N*B + N*B + P*B) * 4``.
* :func:`charge_share_plain` is its plain PyTorch version
  (``ref.charge_share``).

The dispatch between them is :func:`repro_torch.kernels.ops.charge_share`.
"""

from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from repro_torch.kernels import _build, ref

SOURCE = pathlib.Path(__file__).with_name("csrc") / "charge_share.cu"
NAME = "charge_share"
ENTRY = "charge_share_launch"
ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_float, ctypes.c_float, ctypes.c_void_p)
MAX_ROWS = 32

charge_share_plain = ref.charge_share


@functools.lru_cache(maxsize=1)
def build_item() -> tuple[str, str]:
    """``(library name, source)``, the name keyed on a hash of the
    source; also the input of :func:`_build.build_many`."""
    src = SOURCE.read_text()
    return _build.source_name("charge_share", src), src


def library():
    return _build.load(*build_item(), ENTRY, ARGTYPES)


def charge_share_cuda(v: torch.Tensor, caps: torch.Tensor, *, vdd: float,
                      c_bl: float) -> torch.Tensor:
    """v: contiguous [N, B] or [P, N, B] float32, caps: contiguous [N, B]
    float32, both on one CUDA device -> [B] or [P, B] float32."""
    if not (v.is_cuda and caps.is_cuda) or v.device != caps.device:
        raise ValueError("charge_share_cuda takes CUDA tensors on one device")
    if v.dtype != torch.float32 or caps.dtype != torch.float32:
        raise ValueError(f"expected float32, got {v.dtype} and {caps.dtype}")
    if caps.dim() != 2 or v.dim() not in (2, 3) \
            or tuple(v.shape[-2:]) != tuple(caps.shape):
        raise ValueError(f"expected v [N, B] or [P, N, B] and caps [N, B], "
                         f"got {tuple(v.shape)} and {tuple(caps.shape)}")
    n, b = caps.shape
    if not 1 <= n <= MAX_ROWS:
        raise ValueError(f"charge_share takes 1..{MAX_ROWS} rows, got {n}")
    if not (v.is_contiguous() and caps.is_contiguous()):
        raise ValueError("charge_share_cuda takes contiguous tensors")
    p = v.shape[0] if v.dim() == 3 else 1
    out = torch.empty(v.shape[:-2] + (b,), dtype=torch.float32,
                      device=v.device)
    lib = library()
    with torch.cuda.device(v.device):
        rc = lib.charge_share_launch(v.data_ptr(), caps.data_ptr(),
                                     out.data_ptr(), p, n, b, vdd, c_bl,
                                     _build.stream_of(v))
    _build.check(lib, rc, NAME)
    if p * b:
        _build.LAUNCHES[NAME] += 1
    return out
