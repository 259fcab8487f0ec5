"""The MAJ-N kernel's plain version against the reference, bit-exact.

The port's ``ref.maj_n_fast`` (the kernel's bit-sliced counter, the plain
version ``ops.maj_n`` takes for a CPU tensor) and ``ref.maj_n`` (the
bit-unpacking oracle) are held against the reference's Pallas kernel
``repro.kernels.maj_n.maj_n`` run with ``interpret=True`` and against its
jnp oracle ``repro.kernels.ref.maj_n``, on the same seeded planes, for N
1..32 and every threshold. The CUDA kernel itself is held against the
plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as rref
from repro.kernels.maj_n import maj_n as pallas_maj_n
from repro_torch.kernels import maj_n as kmaj
from repro_torch.kernels import ops, ref

W = 1000  # not a multiple of the Pallas block (1024 words): ragged tail


def _planes(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.integers(-2**31, 2**31, (n, W), dtype=np.int64).astype(np.int32)
    x[:, :8] = -1   # every bit set in every plane
    x[:, 8:16] = 0  # no bit set
    return x


def _pallas_thresholds(n: int) -> list[int]:
    """Every threshold at the replica-vote widths, three elsewhere (each
    threshold is its own Pallas trace, half a second on the CPU)."""
    if n in (3, 5, 7):
        return list(range(1, n + 1))
    return sorted({1, n // 2 + 1, n})


@pytest.mark.parametrize("n", range(1, 33))
def test_plain_maj_n_matches_reference(n):
    x = _planes(n, seed=n)
    xt = torch.from_numpy(x)
    xj = jnp.asarray(x)
    for t in range(1, n + 1):
        fast = ref.maj_n_fast(xt, t).numpy()
        np.testing.assert_array_equal(fast, ref.maj_n(xt, t).numpy())
        np.testing.assert_array_equal(fast, np.asarray(rref.maj_n(xj, t)))
        if t in _pallas_thresholds(n):
            np.testing.assert_array_equal(
                fast, np.asarray(pallas_maj_n(xj, t, interpret=True)))


def test_plain_maj_n_counts_bits():
    """Against a NumPy per-bit count: bit b of the output is set iff at
    least ``t`` planes have bit b set."""
    x = _planes(9, seed=99)
    bits = (x.astype(np.int64)[:, :, None] >> np.arange(32)) & 1
    counts = bits.sum(axis=0)  # [W, 32]
    for t in range(1, 10):
        want = ((counts >= t).astype(np.uint64) << np.arange(32,
                                                             dtype=np.uint64)
                ).sum(axis=1).astype(np.uint32).view(np.int32)
        got = ref.maj_n_fast(torch.from_numpy(x), t).numpy()
        np.testing.assert_array_equal(got, want)


def test_cpu_dispatch_takes_the_plain_version():
    x = torch.from_numpy(_planes(5, seed=5))
    before = dict(ops.LAUNCHES)
    np.testing.assert_array_equal(ops.maj_n(x, 3).numpy(),
                                  ref.maj_n_fast(x, 3).numpy())
    assert dict(ops.LAUNCHES) == before  # no kernel launch on the CPU


@pytest.mark.parametrize("n,t", [(3, 0), (3, 4), (0, 1)])
def test_bad_threshold_raises(n, t):
    x = torch.zeros((n, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        ref.maj_n_fast(x, t)
    with pytest.raises(ValueError):
        ref.maj_n(x, t)


def test_cuda_wrapper_refuses_cpu_tensors():
    x = torch.zeros((3, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        kmaj.maj_n_cuda(x, 2)
