"""EngineConfig — the frozen configuration object behind ``pum.device``.

The port's copy of ``repro.pum.config`` plus one field, ``device``: the
``torch.device`` the fused pipeline runs on. It defaults to ``"cuda"``;
on a host without CUDA the default raises instead of dropping to the CPU,
and callers (the CPU tests) pass ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Complete configuration of one PuM device.

    Fields mirror the modeled hardware (``mfr``/``width``/``row_bits``/
    ``banks``), the cost plane (``use_pulsar``/``chained``/``controller``)
    and the execution pipeline (``backend``/``fuse``/auto-flush bounds/
    ``donate_leaves``/``device``). ``fuse`` defaults to **True**: the fused
    lazy pipeline is the production path (bit-exact and stats-identical
    to eager — set ``fuse=False`` for per-op eager execution on the host).

    * ``device`` — the ``torch.device`` (or its name) fused flushes run
      on: ``"cuda"`` runs the hand-written kernels (``vertical-cuda``),
      ``"cpu"`` the word-domain evaluator (``words-torch``).
    * ``backend`` — eager-dataplane name resolved through the
      ``repro_torch.backends`` registry (``"fast"``: packed NumPy words;
      ``"sim"``: the chip model's bit-serial ALU on ``device``, per-op, so
      a sim device never fuses).
    * ``layout`` — plane-layout word bits (32 or 64, or a ``PlaneLayout``);
      ``None`` derives the narrowest layout holding ``width``.
    * ``fused_backend`` — pin a registered fused evaluator by name
      (``"ref-vertical"`` runs the kernels' plain versions).
    * ``donate_leaves`` — uploaded leaf buffers are neither cached nor kept
      after dispatch. Results are bit-identical either way.
    * ``leaf_cache_bytes`` — byte budget of the per-device leaf cache
      (staged wire snapshots and their device tensors, keyed by buffer
      pointer + content fingerprint). ``0``/``None`` disables it.
    * ``success_db`` — optional ``SuccessRateDb`` override.
    * ``reliability`` — ``None`` (default: every path unchanged), or a
      ``repro_torch.reliability.ReliabilityConfig`` / calibrated
      ``ReliabilityMap`` (= config with defaults): the engine plans
      replication per op from the map and — when the config sets
      ``inject=True`` — runs the flush-time fault-injection +
      replica-vote/retry loop on the flush's device (requires
      ``fuse=True``).
    * ``controller`` — ``None`` (closed-form bank divide), ``"auto"``
      (build a ``repro_torch.controller.MemoryController``), or a
      controller instance.
    * ``ref_postponing`` — REF commands batched per rank lockout by the
      ``"auto"`` controller's refresher (1..8; JEDEC allows postponing up
      to 8): longer but rarer refresh windows, priced by ``batch_cost``.
    * ``cmd_buffer_lookahead`` — per-bank command-buffer depth of the
      concurrent-client crossbar (the ``"auto"`` controller's
      ``schedule_concurrent`` default); an execution knob the
      single-stream cost plane never consults.
    """

    mfr: str = "M"
    width: int = 32
    row_bits: int = 65536
    banks: int = 16
    backend: str = "fast"
    use_pulsar: bool = True
    chained: bool = False
    controller: Any = None
    seed: int = 0
    fuse: bool = True
    flush_threshold: int | None = 1024
    flush_memory_bytes: int | None = 1 << 30
    donate_leaves: bool = False
    leaf_cache_bytes: int | None = 1 << 26
    success_db: Any = None
    layout: Any = None
    fused_backend: str | None = None
    ref_postponing: int = 1
    reliability: Any = None
    cmd_buffer_lookahead: int = 8
    device: str = "cuda"

    def __post_init__(self):
        if not 1 <= self.width <= 64:
            raise ValueError(f"width must be in [1, 64], got {self.width}")
        if self.flush_threshold is not None and self.flush_threshold < 1:
            raise ValueError("flush_threshold must be >= 1 or None")
        if self.cmd_buffer_lookahead < 1:
            raise ValueError("cmd_buffer_lookahead must be >= 1 (each "
                             "bank machine holds at least one sequence)")
        if self.leaf_cache_bytes is not None and self.leaf_cache_bytes < 0:
            raise ValueError("leaf_cache_bytes must be >= 0 or None")
        if not 1 <= self.ref_postponing <= 8:
            raise ValueError("ref_postponing must be in [1, 8] (JEDEC "
                             "allows postponing up to 8 REFs)")
        if self.resolved_layout().word_bits < self.width:
            raise ValueError(
                f"width {self.width} does not fit the "
                f"{self.resolved_layout().word_bits}-bit plane layout")

    def resolved_layout(self):
        """The :class:`~repro_torch.kernels.plane_layout.PlaneLayout` this
        config runs on (``layout`` resolved, or derived from ``width``)."""
        from repro_torch.kernels.plane_layout import (get_layout,
                                                      layout_for_width)
        if self.layout is None:
            return layout_for_width(self.width)
        return get_layout(self.layout)

    def replace(self, **changes) -> "EngineConfig":
        """A copy with ``changes`` applied (``dataclasses.replace``)."""
        return dataclasses.replace(self, **changes)
