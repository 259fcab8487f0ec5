"""Fault injection: map-driven bit flips on fused-pipeline outputs.

The port's copy of ``repro.reliability.faults``. The injector turns a
:class:`~repro_torch.reliability.calibration.ReliabilityMap` into concrete
bit-flip masks for one fused program execution:

* each dataplane lane lives in one *column* of one (bank, subarray) home —
  lanes tile across homes in ``n_columns``-sized chunks, in calibration
  order or (with steering) ranked best-first;
* a lane's per-execution flip probability is ``1 - (1 - p_col)^n_ops`` —
  the column is exercised once per row-group op of the program;
* a faulting lane flips ONE uniformly chosen bit of its word.

The masks are drawn on the host from the reference's own NumPy streams
(``np.random.default_rng`` seeded from explicit integer tuples), so a
given (seed, flush, attempt, vote, output) gives the reference's mask bit
for bit. The vote runs on the wire's device: :func:`majority_vote` counts
over int32 wire planes with the MAJ-N kernel (``ops.maj_n``) at the
thresholds the vote needs.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.fused_program import popcount32
from repro_torch.kernels.plane_layout import LAYOUT32, PlaneLayout
from repro_torch.kernels.ref import s32
from repro_torch.reliability.calibration import ReliabilityMap


class FaultInjector:
    """Per-column fault model for one replication config of a map."""

    def __init__(self, rmap: ReliabilityMap, cfg_idx: int, *, width: int,
                 n_ops: int = 1, steer: bool = True,
                 flip_scale: float = 1.0):
        self.rmap = rmap
        self.cfg_idx = cfg_idx
        self.width = width
        self.n_ops = max(1, int(n_ops))
        self.flip_scale = float(flip_scale)
        if steer:
            self.homes = rmap.home_order(cfg_idx)
        else:
            self.homes = [(b, s) for b in range(rmap.n_banks)
                          for s in range(rmap.n_subarrays)]

    def lane_probs(self, n_lanes: int) -> np.ndarray:
        """Per-lane flip probability for one program execution."""
        nc = self.rmap.n_columns
        nh = len(self.homes)
        p = np.empty(n_lanes, np.float64)
        for k in range(0, n_lanes, nc):
            b, s = self.homes[(k // nc) % nh]
            cols = self.rmap.flip_p[b, s, self.cfg_idx]
            take = min(nc, n_lanes - k)
            p[k:k + take] = cols[:take]
        p = np.clip(p * self.flip_scale, 0.0, 1.0)
        return 1.0 - (1.0 - p) ** self.n_ops

    def sample_mask(self, rng: np.random.Generator, p_eff: np.ndarray,
                    dtype: np.dtype) -> tuple[np.ndarray, int]:
        """One execution's flip mask (lane-dtype, XOR onto clean lanes) and
        the number of injected bits."""
        n = p_eff.shape[0]
        flips = rng.random(n) < p_eff
        bits = rng.integers(0, self.width, n).astype(dtype)
        one = np.ones(n, dtype)
        mask = np.where(flips, np.left_shift(one, bits),
                        np.zeros(n, dtype))
        return mask, int(flips.sum())


def _width_mask(width: int, layout: PlaneLayout, device) -> torch.Tensor:
    """int32 mask of the low ``width`` bits of each wire word of a lane
    (one word at 32-bit lanes, the (lo, hi) pair at 64-bit lanes)."""
    words = [s32((1 << max(0, min(32, width - 32 * k))) - 1)
             for k in range(layout.wire_words_per_lane)]
    return torch.tensor(words, dtype=torch.int32, device=device)


def _count_bits(plane: torch.Tensor, wmask: torch.Tensor) -> int:
    masked = plane.view(-1, wmask.numel()) & wmask
    return int(popcount32(masked).sum())


def majority_vote(replicas: torch.Tensor, width: int, min_margin: int,
                  layout: PlaneLayout = LAYOUT32
                  ) -> tuple[torch.Tensor, int, int]:
    """Bitwise majority over ``replicas [R, n]`` (int32 wire words of
    ``layout`` lanes, on any device).

    Returns ``(majority, corrected_bits, weak_bits)``, counted over the low
    ``width`` bits of each lane:

    * ``corrected_bits`` — bit positions where a minority of replicas
      disagreed and was outvoted (vote count ``s`` with ``0 < s < R``);
    * ``weak_bits`` — disagreeing bits whose vote margin ``|2s - R|`` fell
      below ``min_margin`` (too close to trust: the caller retries).

    Every plane is a threshold count ``s >= t`` over the R replicas, one
    ``ops.maj_n`` launch per distinct threshold: the majority is
    ``t = R//2 + 1``, disagreement is ``s >= 1`` and not ``s >= R``, and
    the weak band is ``lo <= s <= hi`` inside ``[1, R - 1]``.
    """
    r = replicas.shape[0]
    planes: dict[int, torch.Tensor] = {}

    def at_least(t: int) -> torch.Tensor:
        if t not in planes:
            planes[t] = ops.maj_n(replicas, t)
        return planes[t]

    maj = at_least(r // 2 + 1)
    if r == 1:
        return maj, 0, 0
    wmask = _width_mask(width, layout, replicas.device)
    dis = at_least(1) & ~at_least(r)
    corrected = _count_bits(dis, wmask)
    # |2s - r| < min_margin  <=>  (r - mm) / 2 < s < (r + mm) / 2.
    lo = max(1, (r - min_margin) // 2 + 1)
    hi = min(r - 1, (r + min_margin - 1) // 2)
    weak = 0
    if lo <= hi:
        band = at_least(lo) & ~at_least(hi + 1)
        weak = _count_bits(band, wmask)
    return maj, corrected, weak
