"""The closed reliability loop: config knob + per-engine runtime plane.

The port's copy of ``repro.reliability.plane``. ``ReliabilityConfig`` is
the frozen knob carried by ``pum.EngineConfig(reliability=...)``: a
calibrated :class:`ReliabilityMap` plus the injection/vote/retry policy.

``ReliabilityPlane`` is the runtime object one ``PulsarEngine`` owns when
the knob is set. It closes the loop in two places of the port:

* **planning** — ``plan_success``/``note_op`` feed calibrated (optionally
  steering-weighted) success rates into the engine's per-op config search,
  replacing the global success table's means;
* **execution** — ``correct()`` wraps each fused-pipeline dispatch: R
  temporal replicas are derived from the clean execution by XOR-ing
  map-driven fault masks, a bitwise majority votes per column (the MAJ-N
  kernel on a CUDA wire), and any disagreeing bit whose vote margin is
  below ``min_margin`` triggers a retry at an *escalated* replication
  config (more copies — Fig 11's reliability lever) with two extra votes,
  bounded by ``max_attempts``. Exhausting the attempts degrades to the
  clean execution, counted as ``reliability.oracle_fallbacks``.

``bank_order`` (placement) is kept for the controller, which the port does
not have yet; with no controller nothing calls it, as in the reference
with ``controller=None``.

The fault masks come from the reference's NumPy streams and the vote counts
the same bits, so for the same map every ``reliability.*`` counter equals
the reference's.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import numpy as np
import torch

from repro_torch.reliability.calibration import ReliabilityMap
from repro_torch.reliability.faults import FaultInjector, majority_vote


@dataclasses.dataclass(frozen=True)
class ReliabilityConfig:
    """Frozen reliability knob for ``pum.EngineConfig(reliability=...)``.

    ``map`` is a calibrated :class:`ReliabilityMap` (or a path to a saved
    one). ``inject=False`` (default) keeps the fused dispatch path
    untouched — the map still drives variation-aware planning. With
    ``inject=True`` every flush runs the vote/retry loop described in the
    module docstring. ``flip_scale`` scales the map's flip probabilities
    (sweeps over lot quality); ``steer=False`` disables weak-column-avoiding
    placement (ablation).
    """

    map: Any = None
    inject: bool = False
    seed: int = 0
    votes: int = 3
    max_attempts: int = 3
    min_margin: int = 2
    target_success: float = 0.99
    steer: bool = True
    flip_scale: float = 1.0

    def __post_init__(self):
        if self.votes < 1 or self.votes % 2 == 0:
            raise ValueError(f"votes must be odd and >= 1, got {self.votes}")
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.min_margin < 1:
            raise ValueError("min_margin must be >= 1")
        if not 0.0 < self.target_success <= 1.0:
            raise ValueError("target_success must be in (0, 1]")
        if self.flip_scale < 0.0:
            raise ValueError("flip_scale must be >= 0")


class ReliabilityPlane:
    """Runtime reliability loop of one engine (see module docstring)."""

    def __init__(self, reliability, *, mfr: str, counters):
        cfg = reliability
        if isinstance(cfg, ReliabilityMap):
            cfg = ReliabilityConfig(map=cfg)
        if not isinstance(cfg, ReliabilityConfig):
            raise TypeError(
                f"reliability= takes a ReliabilityConfig or ReliabilityMap, "
                f"got {type(cfg).__name__}")
        rmap = cfg.map
        if isinstance(rmap, (str, os.PathLike)):
            rmap = ReliabilityMap.load(rmap)
        if not isinstance(rmap, ReliabilityMap):
            raise ValueError(
                "ReliabilityConfig.map must be a ReliabilityMap (run "
                "Device.calibrate() or repro_torch.reliability.calibrate())")
        if rmap.mfr != mfr:
            raise ValueError(
                f"reliability map was calibrated for manufacturer "
                f"{rmap.mfr!r} but the engine models {mfr!r}")
        self.config = cfg
        self.map = rmap
        self.counters = counters
        # Worst (lowest-success) config among the ops recorded since the
        # last flush — the injection/vote loop models that config, since
        # it bounds the program's failure rate.
        self._noted: tuple[float, int, int] | None = None
        self._flush_idx = 0

    @property
    def inject(self) -> bool:
        return self.config.inject

    # ------------------------------------------------------------------ #
    # Planning (engine._cfg_for) and placement

    def plan_success(self, m_inputs: int, n_rg: int) -> float | None:
        """Calibrated success rate for a candidate config, or None when the
        map does not profile it (the engine falls back to the global
        table). With steering the rate is the mean over the better half of
        the placement homes — steered row groups land on strong
        subarrays."""
        i = self.map.config_index(m_inputs, n_rg)
        if i is None:
            return None
        sr = np.sort(self.map.success[:, :, i], axis=None)
        if self.config.steer:
            sr = sr[sr.size // 2:]
        return float(sr.mean())

    def note_op(self, m_inputs: int, n_rg: int, sr: float) -> None:
        """Record one charged op's chosen config; the flush-time vote loop
        injects at the *worst* noted config."""
        if self._noted is None or sr < self._noted[0]:
            self._noted = (sr, m_inputs, n_rg)

    def bank_order(self, banks: int) -> list[int]:
        """Map-ranked bank visit order, restricted/extended to ``banks``
        controller banks."""
        order = [b for b in self.map.bank_order() if b < banks]
        order.extend(b for b in range(banks) if b not in order)
        return order

    # ------------------------------------------------------------------ #
    # Execution (engine.flush dispatch)

    def _flush_config(self) -> tuple[int, int]:
        if self._noted is not None:
            return self._noted[1], self._noted[2]
        m, n = max(self.map.configs, key=lambda c: c[1])
        return m, n

    def correct(self, outs, program, n_lanes: int, span=None):
        """Vote/retry loop over one flushed program's wire outputs.

        ``outs`` are the clean pipeline outputs (int32 wire tensors on the
        engine's device). Returns wire tensors of the same shapes, either
        vote-corrected or — after ``max_attempts`` weak votes — the clean
        outputs themselves. ``n_lanes`` (the graph's unpadded lane count)
        is unused, as in the reference: the masks cover the whole wire,
        padding included.
        """
        cfg = self.config
        cnt = self.counters
        layout, width = program.layout, program.width
        flush_idx = self._flush_idx
        self._flush_idx += 1
        m, n_rg = self._flush_config()
        self._noted = None
        if not outs:
            return outs
        dtype = layout.np_dtype
        base_idx = self.map.config_index(m, n_rg)
        if base_idx is None:
            base_idx = self.map.nearest_config(m, n_rg)
        n_ops = len(program.ops)
        cnt.inc("reliability.flushes")
        votes = cfg.votes
        result = None
        attempts = 0
        for attempt in range(cfg.max_attempts):
            attempts = attempt + 1
            idx = self.map.escalated_config(base_idx, attempt)
            if attempt:
                cnt.inc("reliability.retries")
                if idx != self.map.escalated_config(base_idx, attempt - 1):
                    cnt.inc("reliability.escalations")
            inj = FaultInjector(self.map, idx, width=width, n_ops=n_ops,
                                steer=cfg.steer, flip_scale=cfg.flip_scale)
            corrected_wires = []
            n_corrected = 0
            accepted = True
            for t, wire in enumerate(outs):
                lanes = wire.numel() // layout.wire_words_per_lane
                p_eff = inj.lane_probs(lanes)
                reps = torch.empty((votes, wire.numel()), dtype=torch.int32,
                                   device=wire.device)
                for v in range(votes):
                    rng = np.random.default_rng(
                        [cfg.seed, flush_idx, attempt, v, t])
                    mask, n_flips = inj.sample_mask(rng, p_eff, dtype)
                    cnt.inc("reliability.injected_bits", n_flips)
                    cnt.inc("reliability.exposed_bits", lanes * width)
                    mask_wire = torch.from_numpy(layout.to_wire(mask))
                    torch.bitwise_xor(wire, mask_wire.to(wire.device),
                                      out=reps[v])
                maj, corrected, weak = majority_vote(reps, width,
                                                     cfg.min_margin, layout)
                cnt.inc("reliability.votes_run", votes)
                if weak:
                    cnt.inc("reliability.weak_bits", weak)
                    accepted = False
                    break
                n_corrected += corrected
                corrected_wires.append(maj)
            if accepted:
                # Only the delivered vote's corrections count — discarded
                # (retried) attempts report as weak_bits instead.
                cnt.inc("reliability.corrected_bits", n_corrected)
                result = tuple(corrected_wires)
                break
            votes += 2  # escalate temporal redundancy alongside the config
        fallback = result is None
        if fallback:
            cnt.inc("reliability.oracle_fallbacks")
            result = tuple(outs)
        if span is not None:
            span.args["attempts"] = attempts
            span.args["fallback"] = fallback
        return result
