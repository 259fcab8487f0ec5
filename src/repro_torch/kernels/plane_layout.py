"""PlaneLayout — the explicit word-format contract of the fused dataplane.

The port's copy of ``repro.kernels.plane_layout``. A :class:`PlaneLayout`
names one lane format:

* ``word_bits`` — bits per dataplane lane word (32 or 64);
* lane dtypes (``np_dtype``/``dtype_name``) — what the engine's host-side
  leaf snapshots are carried in (NumPy ``uint32``/``uint64``);
* wire format (``to_wire``/``from_wire``) — every fused pipeline takes
  flat **int32** arrays (``wire_words_per_lane`` words per lane), so the
  pipeline ABI is layout-independent; on the device the wire is an int32
  tensor and unsigned words are carried bit-for-bit in it;
* vertical packing (``pack_planes``/``unpack_planes``) — horizontal wire
  words -> bit planes and back over torch tensors, built from any 32x32
  bit-matrix transpose (the CUDA kernel or its plain version): a 64-bit
  lane transposes as two 32x32 tiles (low/high words);
* raw packed-bitmap split (``raw_lanes``/``join_raw``/
  ``raw_lanes_per_word``) — how a caller-visible uint64 word maps onto
  dataplane lanes in the planewise raw mode (2 lanes at 32-bit words,
  1 lane at 64-bit words).

Layouts are frozen and hashable — a :class:`FusedProgram` carries its
layout, so the structure-keyed pipeline cache keys on it for free.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class PlaneLayout:
    """One lane word format of the fused dataplane (frozen, hashable)."""

    name: str
    word_bits: int

    # ------------------------------------------------------------------ #
    # Lane dtype
    # ------------------------------------------------------------------ #

    @property
    def dtype_name(self) -> str:
        """Unsigned host lane dtype name (NumPy)."""
        return f"uint{self.word_bits}"

    @property
    def np_dtype(self):
        return np.dtype(self.dtype_name)

    @property
    def nbytes_per_word(self) -> int:
        return self.word_bits // 8

    def word_scalar(self, value: int, xp):
        """``value`` as a 0-d lane-dtype scalar of array module ``xp``
        (``numpy`` or ``torch``)."""
        if xp is np:
            return np.asarray(value, self.dtype_name)
        return xp.tensor(value, dtype=getattr(xp, self.dtype_name))

    def mask(self, width: int) -> int:
        """``width``-bit all-ones as a Python int (callers wrap it with
        :meth:`word_scalar` for the module they compute in)."""
        return (1 << width) - 1

    @property
    def swar_consts(self) -> tuple[int, int, int, int]:
        """(m1, m2, m4, h01) repeating-byte masks for ``word_bits``."""
        reps = self.word_bits // 8

        def rep(byte: int) -> int:
            return int.from_bytes(bytes([byte]) * reps, "little")

        return rep(0x55), rep(0x33), rep(0x0F), rep(0x01)

    @property
    def popcount_shift(self) -> int:
        """Final SWAR shift: the count accumulates in the top byte."""
        return self.word_bits - 8

    # ------------------------------------------------------------------ #
    # Wire format: every pipeline ABI is flat int32 arrays
    # ------------------------------------------------------------------ #

    @property
    def wire_words_per_lane(self) -> int:
        return self.word_bits // 32

    def to_wire(self, lanes: np.ndarray) -> np.ndarray:
        """Flat lane-dtype array -> flat int32 wire array (a view when the
        input is contiguous; 64-bit lanes interleave as lo, hi)."""
        return np.ascontiguousarray(lanes).view(np.int32)

    def from_wire(self, wire) -> np.ndarray:
        """Flat int32 wire (NumPy array or tensor on any device) ->
        lane-dtype NumPy array."""
        if isinstance(wire, torch.Tensor):
            wire = wire.cpu().numpy()
        arr = np.ascontiguousarray(np.asarray(wire, np.int32))
        return arr.view(self.np_dtype)

    # ------------------------------------------------------------------ #
    # Raw packed-bitmap mode: caller uint64 words <-> dataplane lanes
    # ------------------------------------------------------------------ #

    @property
    def raw_lanes_per_word(self) -> int:
        """Dataplane lanes per caller-visible uint64 word in raw mode."""
        return 64 // self.word_bits

    def raw_lanes(self, words: np.ndarray) -> np.ndarray:
        """Flat uint64 words -> flat lane-dtype array (bit-preserving
        reinterpretation; the 32-bit layout splits each word in two)."""
        return np.ascontiguousarray(words).view(self.np_dtype)

    def join_raw(self, lanes: np.ndarray) -> np.ndarray:
        """Inverse of :meth:`raw_lanes` (always copies — callers own the
        result)."""
        return np.ascontiguousarray(lanes).copy().view(np.uint64)

    # ------------------------------------------------------------------ #
    # Vertical packing: horizontal wire words <-> bit planes
    # ------------------------------------------------------------------ #

    def pack_planes(self, words: torch.Tensor, transpose, width: int
                    ) -> torch.Tensor:
        """Flat int32 wire tensor -> [width, n/32] int32 bit planes.

        ``transpose`` is any [32, G] -> [32, G] 32x32 bit-matrix
        transpose of a contiguous tensor. Lane count n must be a multiple
        of 32. A 64-bit lane is two stacked 32x32 tiles: low words become
        planes 0..31, high words 32..63. The strided per-word view
        (``words[k::wpl]`` as ``[32, G]``) is made contiguous before the
        transpose sees it.
        """
        wpl = self.wire_words_per_lane
        n = words.shape[0] // wpl
        g = n // 32
        parts = [transpose(words[k::wpl].reshape(g, 32).T.contiguous())
                 for k in range(wpl)]
        planes = parts[0] if wpl == 1 else torch.cat(parts)
        return planes[:width]

    def unpack_planes(self, planes: torch.Tensor, transpose, width: int
                      ) -> torch.Tensor:
        """[width, g] int32 bit planes -> flat int32 wire tensor (the
        inverse of :meth:`pack_planes`; missing high planes are zero)."""
        g = planes.shape[1]
        if width < self.word_bits:
            planes = torch.cat(
                [planes, planes.new_zeros((self.word_bits - width, g))])
        wpl = self.wire_words_per_lane
        parts = [transpose(planes[32 * k:32 * (k + 1)].contiguous())
                 .T.reshape(32 * g) for k in range(wpl)]
        if wpl == 1:
            return parts[0]
        return torch.stack(parts, dim=1).reshape(wpl * 32 * g)


LAYOUT32 = PlaneLayout(name="u32", word_bits=32)
LAYOUT64 = PlaneLayout(name="u64", word_bits=64)

_LAYOUTS = {32: LAYOUT32, 64: LAYOUT64}


def get_layout(word_bits) -> PlaneLayout:
    """Resolve ``word_bits`` (32/64, or a PlaneLayout passed through) to
    a canonical layout."""
    if isinstance(word_bits, PlaneLayout):
        return word_bits
    try:
        return _LAYOUTS[int(word_bits)]
    except (KeyError, TypeError, ValueError):
        raise ValueError(
            f"no plane layout with word_bits={word_bits!r}; "
            f"available: {sorted(_LAYOUTS)}") from None


def layout_for_width(width: int) -> PlaneLayout:
    """The narrowest canonical layout whose word holds ``width`` bits."""
    for bits in sorted(_LAYOUTS):
        if width <= bits:
            return _LAYOUTS[bits]
    raise ValueError(f"no plane layout covers width {width}")
