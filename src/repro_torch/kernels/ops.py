"""Dispatch wrappers for the port's kernels.

Each wrapper launches its hand-written CUDA kernel for a CUDA tensor and
takes the kernel's plain PyTorch version for a CPU tensor — the tensor's
device decides, nothing else: there is no fallback from a failed build or
launch. Launch counts live in :data:`LAUNCHES` (one per kernel launch,
keyed by kernel name; ``LAUNCHES.clear()`` starts a window).

Layout conventions: *horizontal* operands are flat packed words (element
i = word i); *vertical* operands are bit-plane stacks ``[width, W]`` where
plane j holds bit j of every element (``bit_transpose32`` converts 32x32
tiles between the two). ``run_fused_program`` operates on vertical planes.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._build import LAUNCHES  # noqa: F401 (re-export)
from repro_torch.kernels.bit_transpose import (bit_transpose32_cuda,
                                               bit_transpose32_plain)
from repro_torch.kernels.fused_program import (FusedProgram,
                                               run_program_cuda,
                                               run_program_ref)


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
