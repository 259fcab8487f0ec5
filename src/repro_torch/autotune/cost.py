"""Deterministic cost model scoring candidate configs against a profile.

The port's copy of ``repro.autotune.cost``: the three-term roofline
decomposition re-anchored to the fused PuM pipeline — a **compute** term
(weighted word-ops through the candidate backend's modeled throughput), a
**memory** term (operand traffic through the candidate tier's bandwidth),
and an **overhead** term (per-flush dispatch plus pipeline-cache compile
amortization). A fourth **controller** term prices the scheduler effects
the profile actually measured — refresh lockouts shrunk by REF
postponing, tRRD/tFAW stalls shrunk by crossbar lookahead — and is zero
when the window carried no controller counters.

Everything here is a *model*: the point is deterministic, transitive
ranking of candidates from one measured profile (same profile => same
ranking in any process), not absolute wall-clock prediction.

The anchors are the card's: :data:`HBM_BW` and :data:`PEAK_FLOPS`, read
from ``launch/roofline.py``, are the datasheet figures of an NVIDIA H100
80GB HBM3 (SXM) at its 700 W power limit, bf16 dense. The reference
anchors the same model to TPU v5e constants (819e9 B/s, 197e12 FLOP/s),
and the anchors change decisions: a window whose staged leaf bytes
dominate recommends eager execution under the TPU anchors and keeps the
fused pipeline under these. The host tier derives from the anchors when
a window is scored
(:func:`host_anchors`), so the two constants are the only ones to set.
"""

from __future__ import annotations

import dataclasses
import math

# The roofline's card constants (NVIDIA H100 80GB HBM3 SXM, 700 W):
# retune them there and the autotuner moves with them.
from repro_torch.launch.roofline import HBM_BW, PEAK_FLOPS


def host_anchors() -> tuple[float, float]:
    """``(HOST_BW, HOST_WORD_RATE)``: the host tier derived from the chip
    anchors with fixed deratings (a host core sustains ~1/16 of HBM
    bandwidth and a far smaller fraction of the peak on scalar word
    ops), read from the module constants at call time."""
    return HBM_BW / 16.0, PEAK_FLOPS / 1e5


# Modeled relative throughput of each fused backend (word-rate and
# bandwidth multipliers over the host anchors). The word-domain evaluator
# runs at the host anchors; the hand-written vertical kernels carry the
# reference's multipliers for its vertical kernel backend. ``ref-vertical``
# is the kernels' plain version — priced so it can never win (it exists
# to validate the others, mirroring its priority=-10 registration).
BACKEND_SPEED = {
    "words-torch": (1.0, 1.0),
    "words-torch-64": (1.0, 1.0),
    "vertical-cuda": (8.0, 16.0),
    "vertical-cuda-64": (8.0, 16.0),
    "ref-vertical": (0.05, 1.0),
    "ref-vertical-64": (0.05, 1.0),
    # The reference's multipliers, not re-fitted on the card.
    "shard-words": (1.6, 1.6),
}
DEFAULT_SPEED = (0.5, 1.0)         # unknown registered backends

# Fixed per-event costs (seconds): one staged dispatch, one pipeline compile,
# one eager per-op dispatch (backend call + cost-plane charge — what a
# fuse=False candidate pays instead of flush overhead and pipeline compiles).
FLUSH_OVERHEAD_S = 50e-6
COMPILE_S = 30e-3
EAGER_DISPATCH_S = 50e-6

# Word-domain cost weights per fused opcode (multiples of one plane op
# per lane; ``width``-dependent opcodes scale in :func:`_op_weight`).
OP_WEIGHT = {
    "and": 1.0, "or": 1.0, "xor": 1.0, "not": 1.0,
    "add": 1.5, "sub": 1.5, "less_than": 2.0,
    "popcount": 2.0, "reduce_bits": 2.0,
    "fst": 0.0, "snd": 0.0,   # tuple selectors: free at dispatch
}


def _op_weight(opcode: str, width: int) -> float:
    if opcode == "mul":
        return max(2.0, width / 4.0)
    if opcode in ("div", "mod", "divmod"):
        return float(max(4, width))
    return OP_WEIGHT.get(opcode, 1.5)


@dataclasses.dataclass(frozen=True)
class Estimate:
    """Scored candidate: the four modeled terms plus their sum (seconds
    per measured window — only comparisons between candidates scored
    against the SAME profile are meaningful)."""

    compute_s: float
    memory_s: float
    overhead_s: float
    controller_s: float

    @property
    def total_s(self) -> float:
        return (self.compute_s + self.memory_s + self.overhead_s
                + self.controller_s)

    def as_dict(self) -> dict:
        return {"compute_s": self.compute_s, "memory_s": self.memory_s,
                "overhead_s": self.overhead_s,
                "controller_s": self.controller_s,
                "total_s": self.total_s}


class CostModel:
    """Scores ``(profile, candidate-knobs)`` pairs deterministically.

    ``estimate`` accepts any object with the candidate knob attributes
    (``fused_backend``, ``word_bits``, ``flush_threshold``,
    ``flush_memory_bytes``, ``ref_postponing``, ``cmd_buffer_lookahead``,
    and optionally ``fuse`` — absent means fused) — both the tuner's
    internal candidates and a frozen :class:`~repro_torch.autotune.TunedPlan`
    qualify. ``fuse=False`` candidates are priced as the eager per-op
    path: no pipeline compiles and no leaf staging, but ``eager_dispatch_s``
    per recorded op — the term that lets a window whose measured
    ``leaf_bytes_per_flush`` dominates (memory-bound raw AND chains over
    fresh bitmaps) flip the recommendation off the fused pipeline.
    """

    def __init__(self, *, speed=None, flush_overhead_s: float =
                 FLUSH_OVERHEAD_S, compile_s: float = COMPILE_S,
                 eager_dispatch_s: float = EAGER_DISPATCH_S):
        self.speed = dict(BACKEND_SPEED if speed is None else speed)
        self.flush_overhead_s = flush_overhead_s
        self.compile_s = compile_s
        self.eager_dispatch_s = eager_dispatch_s

    # -- candidate-adjusted workload geometry --------------------------- #

    def _lanes(self, profile, word_bits: int) -> float:
        """Mean lanes per flush under the candidate layout: raw-mode ops
        split each caller uint64 into ``64 / word_bits`` lanes, so the
        raw share of the measured lane count rescales by the ratio of
        candidate to measured raw splits; value-mode lanes are one per
        element regardless of layout."""
        raw = profile.raw_fraction
        if raw <= 0 or profile.word_bits == word_bits:
            return profile.lanes
        scale = (64.0 / word_bits) / (64.0 / profile.word_bits)
        return profile.lanes * ((1.0 - raw) + raw * scale)

    def _flush_geometry(self, profile, knobs,
                        lanes: float) -> tuple[float, int]:
        """``(depth, n_flushes)`` of the window under the candidate's
        auto-flush bounds. When the measured window was dominated by
        threshold-forced flushes (``autoflush_ops_fraction >= 0.5``) the
        *natural* program is longer than any one measured graph — the
        whole window is treated as one logical program that candidate
        thresholds re-chunk, so a larger ``flush_threshold`` genuinely
        merges flushes (and a smaller one splits them)."""
        depth = max(1.0, profile.ops_per_flush)
        flushes = max(1, profile.flushes)
        window_ops = depth * flushes
        natural = (window_ops
                   if profile.autoflush_ops_fraction >= 0.5 else depth)
        cap = float(natural)
        if knobs.flush_threshold is not None:
            cap = min(cap, float(knobs.flush_threshold))
        if knobs.flush_memory_bytes is not None:
            per_op_bytes = 2.0 * lanes * (knobs.word_bits // 8)
            if per_op_bytes > 0:
                cap = min(cap, knobs.flush_memory_bytes / per_op_bytes)
        cap = max(1.0, cap)
        return cap, math.ceil(window_ops / cap)

    # -- scoring -------------------------------------------------------- #

    def estimate(self, profile, knobs) -> Estimate:
        """Modeled seconds for one measured window re-run under
        ``knobs`` (see class docstring for the knob attributes)."""
        word_rate, bw = self.speed.get(knobs.fused_backend, DEFAULT_SPEED)
        host_bw, host_word_rate = host_anchors()
        lanes = self._lanes(profile, knobs.word_bits)
        depth = max(1.0, profile.ops_per_flush)
        flushes = max(1, profile.flushes)
        weight = sum(frac * _op_weight(op, profile.width)
                     for op, frac in sorted(profile.op_mix.items())) or 1.0

        # Compute: weighted word-ops through the backend's lane rate.
        word_ops = lanes * depth * weight * flushes
        compute_s = word_ops / (host_word_rate * word_rate)

        # Memory: ~3 operand streams per op through the backend's tier.
        byte_traffic = 3.0 * lanes * (knobs.word_bits // 8) \
            * depth * flushes
        memory_s = byte_traffic / (host_bw * bw)

        if getattr(knobs, "fuse", True):
            # Leaf staging: the snapshot/upload bytes the flush path
            # actually measured (net of leaf-cache hits and elided
            # snapshots), re-paid per flush through host DRAM. Folded
            # into the memory term — it is data movement, and it is the
            # cost eager execution never pays (operands stream in place,
            # un-snapshotted).
            memory_s += profile.leaf_bytes_per_flush * flushes / host_bw

            # Overhead: staged dispatches (candidate thresholds re-chunk
            # the window, see _flush_geometry) plus compile amortization.
            # A candidate whose chunking differs from the measured
            # structure pays at least one fresh compile over the window.
            depth_c, n_flushes = self._flush_geometry(profile, knobs,
                                                      lanes)
            miss_rate = 1.0 - profile.cache_hit_rate
            if abs(depth_c - depth) > 0.5:
                miss_rate = max(miss_rate, 1.0 / n_flushes)
            overhead_s = n_flushes * self.flush_overhead_s \
                + miss_rate * n_flushes * self.compile_s
        else:
            # Eager (fuse=False): the host word dataplane at the base
            # anchors — no fused backend, no compiles, no leaf
            # snapshots — but one dispatch per recorded op.
            compute_s = word_ops / host_word_rate
            memory_s = byte_traffic / host_bw
            overhead_s = depth * flushes * self.eager_dispatch_s

        # Controller: measured refresh/stall shares of the dataplane
        # time, shrunk by the candidate's REF postponing (longer, rarer
        # lockouts amortize per-REF overhead) and command lookahead
        # (deeper reordering hides tRRD/tFAW spacing).
        base = compute_s + memory_s
        refresh_s = base * profile.refresh_fraction \
            * (0.85 + 0.15 / knobs.ref_postponing)
        stall_frac = (profile.stall_trrd_fraction
                      + profile.stall_tfaw_fraction)
        stall_s = base * stall_frac \
            / (1.0 + math.log2(max(1, knobs.cmd_buffer_lookahead)) / 6.0)
        return Estimate(compute_s=compute_s, memory_s=memory_s,
                        overhead_s=overhead_s,
                        controller_s=refresh_s + stall_s)
