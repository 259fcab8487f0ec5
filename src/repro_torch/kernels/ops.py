"""Dispatch wrappers for the port's kernels.

Each wrapper launches its hand-written CUDA kernel for a CUDA tensor and
takes the kernel's plain PyTorch version for a CPU tensor — the tensor's
device decides, nothing else: there is no fallback from a failed build or
launch. Launch counts live in :data:`LAUNCHES` (one per kernel launch,
keyed by kernel name; ``LAUNCHES.clear()`` starts a window).

Layout conventions: *horizontal* operands are flat packed words (element
i = word i); *vertical* operands are bit-plane stacks ``[width, W]`` where
plane j holds bit j of every element (``bit_transpose32`` converts 32x32
tiles between the two). ``run_fused_program`` operates on vertical planes;
``maj_n`` on any stack of packed 32-bit planes; ``bitserial_add`` on two
plane stacks ``[width, W]`` (values unsigned modulo 2**width);
``charge_share`` on float32 cell fields ``[..., N rows, B bitlines]``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._build import LAUNCHES  # noqa: F401 (re-export)
from repro_torch.kernels.bit_transpose import (bit_transpose32_cuda,
                                               bit_transpose32_plain)
from repro_torch.kernels.bitserial_add import (bitserial_add_cuda,
                                               bitserial_add_plain)
from repro_torch.kernels.charge_share import (charge_share_cuda,
                                              charge_share_plain)
from repro_torch.kernels.fused_program import (FusedProgram,
                                               run_program_cuda,
                                               run_program_ref)
from repro_torch.kernels.maj_n import maj_n_cuda, maj_n_plain


def bit_transpose32(x: torch.Tensor) -> torch.Tensor:
    """[32, G] int32 -> tile-wise 32x32 bit transpose."""
    if x.is_cuda:
        return bit_transpose32_cuda(x)
    return bit_transpose32_plain(x)


def run_fused_program(program: FusedProgram, x: torch.Tensor
                      ) -> torch.Tensor:
    """Evaluate a fused program on vertical plane stacks: x [n_in, width,
    W] int32 -> [n_out, width, W]."""
    if x.is_cuda:
        return run_program_cuda(program, x)
    return run_program_ref(program, x)


def maj_n(x: torch.Tensor, threshold: int) -> torch.Tensor:
    """[N, W] int32 packed planes -> [W]: bit set where at least
    ``threshold`` of the N planes have it set."""
    if x.is_cuda:
        return maj_n_cuda(x, threshold)
    return maj_n_plain(x, threshold)


def bitserial_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Vertical ripple add: a, b [width, W] int32 plane stacks -> [width,
    W] sum planes (carry = MAJ3(a, b, carry), carry-out dropped)."""
    if a.is_cuda:
        return bitserial_add_cuda(a, b)
    return bitserial_add_plain(a, b)


def charge_share(v: torch.Tensor, caps: torch.Tensor, *, vdd: float,
                 c_bl: float) -> torch.Tensor:
    """Bitline deviation: v [N, B] or [P, N, B], caps [N, B] float32 ->
    [B] or [P, B] volts."""
    if v.is_cuda:
        return charge_share_cuda(v, caps, vdd=vdd, c_bl=c_bl)
    return charge_share_plain(v, caps, vdd=vdd, c_bl=c_bl)
