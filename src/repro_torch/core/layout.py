"""Vertical data layout (paper §2.4).

The port's copy of ``repro.core.layout``. It stays host NumPy on uint64
values, as in the reference: torch has no CPU uint64 arithmetic, and the
engine's eager dataplane carries its values as uint64 ndarrays. The planes
move to the chip's device when ``PulsarChip.write_row`` stores them.

Bit-serial PuM places all bits of an element in one DRAM column (bitline):
bit ``j`` of element ``i`` lives on bit-plane row ``j``, bitline ``i``.
Planes are packed uint32 words (bitline ``32w + b`` = bit ``b`` of word ``w``).

``to_vertical`` / ``from_vertical`` are the host-side transposes (the
on-card equivalent is kernels/bit_transpose). Shifts in vertical layout
are free — they rename plane rows instead of moving data.
"""

from __future__ import annotations

import numpy as np


def pack_bits(bits: np.ndarray) -> np.ndarray:
    """[..., n_bits] {0,1} -> [..., n_bits/32] uint32 (little-endian lanes)."""
    bits = np.asarray(bits, np.uint8)
    if bits.shape[-1] % 32:
        raise ValueError("n_bits must be a multiple of 32")
    return np.packbits(bits, axis=-1, bitorder="little").view(np.uint32)


def unpack_bits(words: np.ndarray, n_bits: int | None = None) -> np.ndarray:
    """[..., W] uint32 -> [..., 32W] {0,1} uint8."""
    w8 = np.asarray(words, np.uint32).view(np.uint8)
    bits = np.unpackbits(w8, axis=-1, bitorder="little")
    return bits if n_bits is None else bits[..., :n_bits]


def to_vertical(values: np.ndarray, width: int) -> np.ndarray:
    """[n] unsigned ints -> [width, n/32] uint32 bit-planes."""
    values = np.asarray(values, np.uint64)
    n = values.shape[0]
    if n % 32:
        raise ValueError("element count must be a multiple of 32")
    planes = np.empty((width, n // 32), np.uint32)
    for j in range(width):
        planes[j] = pack_bits(((values >> j) & 1).astype(np.uint8))
    return planes


def from_vertical(planes: np.ndarray, signed: bool = False) -> np.ndarray:
    """[width, W] uint32 bit-planes -> [32W] ints (two's complement when
    ``signed``)."""
    width = planes.shape[0]
    vals = np.zeros(planes.shape[1] * 32, np.uint64)
    for j in range(width):
        vals |= unpack_bits(planes[j]).astype(np.uint64) << j
    if signed:
        sign = (vals >> (width - 1)) & 1
        vals = vals.astype(np.int64) - (sign.astype(np.int64) << width)
        return vals
    return vals
