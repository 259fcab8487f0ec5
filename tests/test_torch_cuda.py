"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test needs a CUDA card and ``nvcc`` and skips with
a reason elsewhere (whether a card is present is decided inside the
test, never at import). On a GPU host:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.convert import program_from_reference
from repro_torch.kernels import fused_program as tfp
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("g", [1, 7, 1000, 65536])
def test_bit_transpose_kernel_matches_plain(cuda, g):
    x = torch.randint(-2**31, 2**31 - 1, (32, g), dtype=torch.int32,
                      device=cuda)
    before = ops.LAUNCHES["bit_transpose32"]
    got = ops.bit_transpose32(x)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.bit_transpose32(x))
    assert ops.LAUNCHES["bit_transpose32"] == before + 1


@pytest.mark.parametrize("width", [8, 16, 32, 33, 64])
def test_fused_program_kernel_matches_plain(cuda, width):
    from test_torch_fused_program import random_program
    rng = np.random.default_rng(width)
    prog = program_from_reference(*random_program(rng, width),
                                  32 if width <= 32 else 64)
    x = torch.randint(-2**31, 2**31 - 1, (3, width, 3000),
                      dtype=torch.int32, device=cuda)
    x[1, :, :100] = 0  # zero divisors
    before = ops.LAUNCHES["run_program_cuda"]
    got = ops.run_fused_program(prog, x)
    torch.cuda.synchronize()
    assert torch.equal(got, tfp.run_program_ref(prog, x))
    assert ops.LAUNCHES["run_program_cuda"] == before + 1


def test_engine_on_the_card_matches_host(cuda):
    import repro_torch.pum as pum
    from test_torch_cost_plane import prog16
    rng = np.random.default_rng(1)
    a, b, c = (rng.integers(0, 2**32, 1 << 16, dtype=np.uint64)
               for _ in range(3))
    dev = pum.device(width=32)
    host = pum.device(width=32, fuse=False)
    np.testing.assert_array_equal(prog16(dev, a, b, c).to_numpy(),
                                  prog16(host, a, b, c).to_numpy())
    assert dev.stats == host.stats
