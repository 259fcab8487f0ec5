"""The MAJ-N kernel's plain version against the reference, bit-exact.

The port's ``ref.maj_n_fast`` (the kernel's bit-sliced counter, the plain
version ``ops.maj_n`` takes for a CPU tensor) and ``ref.maj_n`` (the
bit-unpacking oracle) are held against the reference's Pallas kernel
``repro.kernels.maj_n.maj_n`` run with ``interpret=True`` and against its
jnp oracle ``repro.kernels.ref.maj_n``, on the same seeded planes, for N
1..32 and every threshold. So is ``ref.maj_n_grouped``, the CUDA kernel's
split of the planes into row groups whose counters meet in a tree of
ripple adders, at 1, 2, 3, 4 and 8 groups; and ``maj_n.geometry``, the
launch shape the wrapper picks, is checked to cover every column and
plane once. The CUDA kernel itself is held against the plain version on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

from __future__ import annotations

import functools

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


@functools.lru_cache(maxsize=None)
def _pallas(n: int, t: int) -> np.ndarray:
    """The reference's Pallas kernel in interpret mode on ``_planes(n,
    seed=n)`` (cached: each threshold is its own trace)."""
    return np.asarray(pallas_maj_n(jnp.asarray(_planes(n, seed=n)), t,
                                   interpret=True))


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
            np.testing.assert_array_equal(fast, _pallas(n, t))


GROUPS = (1, 2, 3, 4, 8)


@pytest.mark.parametrize("n", list(range(1, 34)) + [63, 64, 65, 255, 256,
                                                    1024])
def test_grouped_maj_n_matches_reference(n):
    """The kernel's decomposition, bit-exact against the reference's
    oracle at every threshold for N <= 33 (three thresholds above) and
    against its Pallas kernel at the thresholds ``_pallas_thresholds``
    picks for N <= 32 (the traces the test above caches); every group
    count of ``GROUPS`` up to N, uneven splits included (3 groups of 31
    planes are 10, 10, 11)."""
    x = _planes(n, seed=n)
    xt = torch.from_numpy(x)
    xj = jnp.asarray(x)
    ts = range(1, n + 1) if n <= 33 else sorted({1, n // 2 + 1, n})
    for t in ts:
        want = [np.asarray(rref.maj_n(xj, t))]
        if n <= 32 and t in _pallas_thresholds(n):
            want.append(_pallas(n, t))
        for g in (g for g in GROUPS if g <= n):
            got = ref.maj_n_grouped(xt, t, g).numpy()
            for w in want:
                np.testing.assert_array_equal(
                    got, w, err_msg=f"N={n} threshold {t} groups {g}")


def test_grouped_maj_n_refuses_bad_groups():
    x = torch.zeros((3, 4), dtype=torch.int32)
    for g in (0, 4):
        with pytest.raises(ValueError, match="groups"):
            ref.maj_n_grouped(x, 2, g)


def _cover(n: int, w: int, groups: int, tile: int, aligned: bool):
    """How often the kernel's launch at ``(groups, tile)`` reads each
    (plane, column) of ``[n, w]`` and writes each column: block b, thread
    (t, g) holds words ``b*tile + 4t + q`` (16-byte loads) or ``b*tile +
    q*tpg + t`` (4-byte loads), q < 4, below w, and adds planes
    ``[g*n//groups, (g+1)*n//groups)``; group 0 writes."""
    tpg = tile // kmaj.VEC
    reads = np.zeros((n, max(w, 1)), np.int64)
    writes = np.zeros(max(w, 1), np.int64)
    t, q = np.meshgrid(np.arange(tpg), np.arange(kmaj.VEC), indexing="ij")
    for b in range(-(-w // tile)):
        cols = (b * tile + (kmaj.VEC * t + q if aligned else q * tpg + t)
                ).ravel()
        cols = cols[cols < w]
        np.add.at(writes, cols, 1)
        for g in range(groups):
            rows = np.arange(g * n // groups, (g + 1) * n // groups)
            np.add.at(reads, (rows[:, None], cols[None, :]), 1)
    return reads[:, :w], writes[:w]


@pytest.mark.parametrize("w", [1, 31, 1000, 2048, 2049, 65536, 1 << 21])
@pytest.mark.parametrize("n", [1, 3, 7, 8, 15, 31, 32, 33, 255, 4096,
                               65535])
def test_geometry_covers_every_column_and_plane_once(n, w):
    groups, tile = kmaj.geometry(n, w)
    tpg = tile // kmaj.VEC
    k = n.bit_length()
    assert 1 <= groups <= n and tile % kmaj.VEC == 0 and tpg >= 1
    assert tpg * groups <= kmaj.MAX_THREADS
    assert groups == 1 or groups * (k + 1) * tpg * 16 <= kmaj.SMEM_BYTES
    if n * w > 1 << 24:  # model the launch where it stays small here
        n = min(n, 8)
        groups = min(groups, n)
        w_model = min(w, 8 * tile + 3)
    else:
        w_model = w
    for aligned in ([True, False] if w_model % 4 == 0 else [False]):
        reads, writes = _cover(n, w_model, groups, tile, aligned)
        assert (reads == 1).all() and (writes == 1).all()


@pytest.mark.parametrize("n", range(1, 33))
def test_geometry_at_the_chip_shape_is_one_latency_round(n):
    """[N <= 32, 2048]: at most 4 planes a thread."""
    groups, _ = kmaj.geometry(n, 2048)
    assert -(-n // groups) <= kmaj.ROUND_PLANES


@pytest.mark.parametrize("n", [1, 3, 16, 31, 32, 255, 4096, 65535])
@pytest.mark.parametrize("w", [65536, 1 << 18, 1 << 21])
def test_geometry_fills_every_sm_at_large_widths(n, w):
    groups, tile = kmaj.geometry(n, w)
    assert -(-w // tile) >= 2 * 132


@pytest.mark.parametrize("n,w", [(0, 8), (65536, 8), (3, -1)])
def test_geometry_refuses_out_of_range(n, w):
    with pytest.raises(ValueError):
        kmaj.geometry(n, w)


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
