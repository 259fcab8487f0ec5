"""Port bit-transpose plain version and plane packing vs the reference.

The port's plain ``bit_transpose32`` (what the CUDA kernel is held
against on the card) must be bit-exact with the reference's jnp oracle
and with the reference's Pallas kernel in interpret mode; the port's
``pack_planes``/``unpack_planes`` must produce the reference's planes and
round-trip the wire at both layouts.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.kernels import bit_transpose as rbt
from repro.kernels import ref as rref
from repro.kernels.plane_layout import get_layout as ref_layout
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.plane_layout import get_layout


def _tiles(g: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2**32, (32, g), dtype=np.uint64).astype(np.uint32)
    x[:, 0] = [0xFFFFFFFF if k % 3 else 0x80000001 for k in range(32)]
    return x.view(np.int32)


@pytest.mark.parametrize("g", [1, 7, 128, 1000])
def test_plain_matches_reference_oracle(g):
    x = _tiles(g, g)
    want = np.asarray(rref.bit_transpose32(x))
    got = tref.bit_transpose32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    # The CPU dispatch takes the plain version (no launch is counted).
    before = ops.LAUNCHES["bit_transpose32"]
    np.testing.assert_array_equal(
        ops.bit_transpose32(torch.from_numpy(x)).numpy(), want)
    assert ops.LAUNCHES["bit_transpose32"] == before


@pytest.mark.parametrize("g", [1, 7, 128, 1000])
def test_plain_matches_pallas_interpret(g):
    x = _tiles(g, 10 + g)
    want = np.asarray(rbt.bit_transpose32(x, interpret=True))
    got = tref.bit_transpose32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_transpose_semantics_lsb_first():
    """out[j] bit i == x[i] bit j, per tile (the reference's contract)."""
    x = _tiles(3, 99)
    out = tref.bit_transpose32(torch.from_numpy(x)).numpy().view(np.uint32)
    xu = x.view(np.uint32)
    for t in range(3):
        for i in range(32):
            for j in range(32):
                assert (out[j, t] >> i) & 1 == (xu[i, t] >> j) & 1


def test_plain_is_an_involution():
    x = torch.from_numpy(_tiles(64, 5))
    assert torch.equal(tref.bit_transpose32(tref.bit_transpose32(x)), x)


LAYOUT_WIDTHS = [(32, 1), (32, 8), (32, 32),
                 (64, 1), (64, 8), (64, 32), (64, 33), (64, 64)]


@pytest.mark.parametrize("word_bits,width", LAYOUT_WIDTHS)
def test_pack_unpack_match_reference(word_bits, width):
    rng = np.random.default_rng(word_bits * 100 + width)
    n = 32 * 9
    hi = 1 << width
    lanes = (rng.integers(0, hi, n, dtype=np.uint64) if width < 64 else
             rng.integers(0, 2**64 - 1, n, dtype=np.uint64, endpoint=True))
    rlay, tlay = ref_layout(word_bits), get_layout(word_bits)
    wire = rlay.to_wire(lanes.astype(rlay.np_dtype))
    want_planes = np.asarray(rlay.pack_planes(wire, rref.bit_transpose32,
                                              width))
    got_planes = tlay.pack_planes(torch.from_numpy(wire),
                                  tref.bit_transpose32, width)
    np.testing.assert_array_equal(got_planes.numpy(), want_planes)
    want_wire = np.asarray(rlay.unpack_planes(want_planes,
                                              rref.bit_transpose32, width))
    got_wire = tlay.unpack_planes(got_planes, tref.bit_transpose32, width)
    np.testing.assert_array_equal(got_wire.numpy(), want_wire)
    # Round trip: width-bit lanes come back unchanged (planes above
    # ``width`` unpack as zero).
    np.testing.assert_array_equal(got_wire.numpy(), wire)


def test_lsr_masks_the_sign_fill():
    x = torch.tensor([-1, -2**31, 2**31 - 1, 5], dtype=torch.int32)
    for k in range(32):
        want = (x.numpy().view(np.uint32) >> np.uint32(k)).view(np.int32)
        np.testing.assert_array_equal(tref.lsr(x, k).numpy(), want)
