"""The bit-serial add kernel's plain version against the reference.

``ref.bitserial_add`` (the plain version of ``csrc/bitserial_add.cu``) is
held bit-exact against the reference's oracle
``repro.kernels.ref.bitserial_add`` and the Pallas kernel
``repro.kernels.bitserial_add.bitserial_add`` in interpret mode (as
``tests/kernels/test_kernels.py`` runs it), at widths 1, 8, 32 and 64 and
a ragged word count, on the same seeded NumPy planes. The CUDA kernel
itself is held against this plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as rref
from repro.kernels.bitserial_add import bitserial_add as pallas_add
from repro_torch.core.layout import from_vertical, to_vertical
from repro_torch.kernels import bitserial_add, ops, ref
from repro_torch.kernels.bitserial_add import bitserial_add_cuda


def planes(width, w, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-2**31, 2**31, (width, w), dtype=np.int64
                        ).astype(np.int32)


@pytest.mark.parametrize("width", [1, 8, 32, 64])
@pytest.mark.parametrize("w", [1001, 64])
def test_plain_matches_reference_and_pallas(width, w):
    a, b = planes(width, w, width), planes(width, w, width + 100)
    a[:, :5] = -1  # carries ripple through every plane
    got = ref.bitserial_add(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(rref.bitserial_add(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(got, want)
    pal = np.asarray(pallas_add(jnp.asarray(a), jnp.asarray(b),
                                interpret=True))
    np.testing.assert_array_equal(got, pal)


@pytest.mark.parametrize("width", [1, 8, 16, 32, 33, 64])
def test_plain_adds_modulo_width(width):
    rng = np.random.default_rng(width)
    hi = 2**64 - 1 if width == 64 else (1 << width) - 1
    x = rng.integers(0, hi, 320, dtype=np.uint64, endpoint=True)
    y = rng.integers(0, hi, 320, dtype=np.uint64, endpoint=True)
    pa = torch.from_numpy(to_vertical(x, width).view(np.int32))
    pb = torch.from_numpy(to_vertical(y, width).view(np.int32))
    got = from_vertical(ops.bitserial_add(pa, pb).numpy().view(np.uint32))
    want = x + y  # uint64 wraps modulo 2**64
    if width < 64:
        want &= np.uint64(hi)
    np.testing.assert_array_equal(got, want)


def test_package_exports_the_dispatch():
    assert bitserial_add is ops.bitserial_add


def test_cpu_dispatch_takes_the_plain_version():
    a, b = (torch.from_numpy(planes(8, 100, s)) for s in (1, 2))
    before = dict(ops.LAUNCHES)
    np.testing.assert_array_equal(ops.bitserial_add(a, b).numpy(),
                                  ref.bitserial_add(a, b).numpy())
    assert dict(ops.LAUNCHES) == before  # no kernel launch on the CPU


def test_bad_operands_raise():
    a = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="shape mismatch"):
        ref.bitserial_add(a, torch.zeros((4, 9), dtype=torch.int32))
    with pytest.raises(ValueError, match="width"):
        ref.bitserial_add(a[:0], a[:0])
    with pytest.raises(ValueError, match="CUDA"):
        bitserial_add_cuda(a, a)
