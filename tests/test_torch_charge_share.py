"""The charge-sharing kernel's plain version against the reference.

``ref.charge_share`` (the plain version ``ops.charge_share`` takes for a
CPU tensor) against the reference's Pallas kernel
``repro.kernels.charge_share.charge_share`` run with ``interpret=True``,
on the same seeded float32 fields. Tolerance: rtol 1e-5, atol 1e-7 V —
the sums run in another order (a row-order loop in the kernels, a
pairwise reduction in torch), a few float32 ulps of the ~0.1 V results.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.charge_share import charge_share as pallas_charge_share
from repro_torch.core.profiles import MFR_H
from repro_torch.kernels import charge_share as kcs
from repro_torch.kernels import ops, ref

RTOL, ATOL = 1e-5, 1e-7
VDD, C_BL = MFR_H.vdd, MFR_H.bitline_cap_ff


def _fields(n: int, b: int, seed: int, p: int | None = None):
    rng = np.random.default_rng(seed)
    shape = (n, b) if p is None else (p, n, b)
    v = (rng.integers(0, 2, shape) * VDD).astype(np.float32)
    v[..., :1, :] = 0.5 * VDD  # a Frac-neutral row
    caps = (MFR_H.cell_cap_ff * (1 + 0.2 * rng.standard_normal((n, b)))
            ).astype(np.float32)
    return v, caps


@pytest.mark.parametrize("n,b", [(1, 300), (3, 1024), (4, 1000),
                                 (8, 2053), (16, 4096), (32, 1500)])
def test_plain_matches_pallas(n, b):
    v, caps = _fields(n, b, seed=n * b)
    want = np.asarray(pallas_charge_share(jnp.asarray(v), jnp.asarray(caps),
                                          vdd=VDD, c_bl=C_BL,
                                          interpret=True))
    got = ref.charge_share(torch.from_numpy(v), torch.from_numpy(caps),
                           vdd=VDD, c_bl=C_BL).numpy()
    assert got.dtype == np.float32 and got.shape == (b,)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_patterns_share_caps():
    """[P, N, B] fields against caps [N, B]: each pattern's row equals the
    [N, B] call on that pattern (the layout the analog model sweeps)."""
    v, caps = _fields(12, 777, seed=3, p=5)
    ct = torch.from_numpy(caps)
    got = ops.charge_share(torch.from_numpy(v), ct, vdd=VDD, c_bl=C_BL)
    assert got.shape == (5, 777)
    for p in range(5):
        want = np.asarray(pallas_charge_share(
            jnp.asarray(v[p]), jnp.asarray(caps), vdd=VDD, c_bl=C_BL,
            interpret=True))
        np.testing.assert_allclose(got[p].numpy(), want, rtol=RTOL,
                                   atol=ATOL)


def test_cpu_dispatch_takes_the_plain_version():
    v, caps = _fields(8, 500, seed=8)
    before = dict(ops.LAUNCHES)
    got = ops.charge_share(torch.from_numpy(v), torch.from_numpy(caps),
                           vdd=VDD, c_bl=C_BL)
    want = kcs.charge_share_plain(torch.from_numpy(v),
                                  torch.from_numpy(caps), vdd=VDD, c_bl=C_BL)
    assert torch.equal(got, want)
    assert dict(ops.LAUNCHES) == before


def test_cuda_wrapper_refuses_cpu_tensors():
    v, caps = _fields(4, 64, seed=1)
    with pytest.raises(ValueError, match="CUDA"):
        kcs.charge_share_cuda(torch.from_numpy(v), torch.from_numpy(caps),
                              vdd=VDD, c_bl=C_BL)
