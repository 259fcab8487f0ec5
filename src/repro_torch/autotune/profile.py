"""WorkloadProfile — what the telemetry counters say a workload *is*.

The port's copy of ``repro.autotune.profile``, reading the same counter
names from :class:`~repro_torch.telemetry.CounterBank`. The autotuner
never looks at raw counter dumps: it looks at a
:class:`WorkloadProfile`, a small frozen summary extracted from a
:class:`~repro_torch.telemetry.CounterBank` window (typically a
``CounterBank.delta`` between two ``snapshot()`` calls, or the bank a
``pum.profile()`` block populated). The profile normalizes everything to
rates and fractions so two windows of different lengths describe the
same workload identically — that is what makes the drift detector and
the cross-process determinism guarantee possible.

Engine counters feeding the profile (written while a tracer is
attached): ``engine.ops_recorded`` /
``engine.op.<opcode>`` / ``engine.raw_ops`` for the op mix,
``engine.flushes`` + the ``engine.flush_lanes`` histogram for graph
depth and lane count, ``engine.pipeline_cache.{hit,miss}`` for compile
amortization, ``engine.autoflush.{ops,memory}`` for threshold pressure,
``engine.leaf_bytes_staged`` + ``engine.leaf_cache.{hits,misses}`` for
flush-path data movement (what leaf snapshots actually cost — the term
that lets the cost model price fused staging against eager streaming).
Controller counters (``derive_controller_counters`` replays of the
scheduler audit trail) contribute the bus-utilization / stall-split /
row-conflict / refresh features when present; they default to zero when
the window carried no scheduled command trace.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json


def _counters_mapping(counters) -> tuple[dict, dict]:
    """Normalize a CounterBank / as_dict() payload / plain mapping to
    ``(counters, histograms)`` dicts."""
    if hasattr(counters, "as_dict"):
        d = counters.as_dict()
        return d["counters"], d["histograms"]
    if isinstance(counters, dict) and "counters" in counters:
        return dict(counters["counters"]), dict(counters.get(
            "histograms", {}))
    return dict(counters), {}


@dataclasses.dataclass(frozen=True)
class WorkloadProfile:
    """Frozen, JSON-round-trippable summary of one measured window.

    All features are window-length independent (fractions, means,
    ratios); ``ops`` and ``flushes`` carry the absolute window size for
    confidence weighting. ``width``/``word_bits`` record the device
    configuration the window was measured under — the cost model needs
    them to rescale lane counts for candidate layouts.
    """

    ops: int = 0                    # dataplane ops recorded in the window
    flushes: int = 0                # fused flushes dispatched
    ops_per_flush: float = 0.0      # mean graph depth at dispatch
    lanes: float = 0.0              # mean dataplane lanes per flush
    op_mix: dict = dataclasses.field(default_factory=dict)
    raw_fraction: float = 0.0       # share of ops on the raw bitmap path
    cache_hit_rate: float = 0.0     # pipeline-cache hits / flushes
    autoflush_ops_fraction: float = 0.0     # flushes forced by op count
    autoflush_memory_fraction: float = 0.0  # flushes forced by memory est
    leaf_bytes_per_flush: float = 0.0  # staged leaf-snapshot bytes / flush
    leaf_cache_hit_rate: float = 0.0   # leaf-cache hits / lookups
    bus_utilization: float = 0.0    # cmd-bus busy / wall (controller)
    stall_trrd_fraction: float = 0.0   # tRRD stall / wall
    stall_tfaw_fraction: float = 0.0   # tFAW stall / wall
    row_conflict_ratio: float = 0.0    # conflicts / column commands
    refresh_fraction: float = 0.0      # refresh stall / wall
    width: int = 32                 # device element width measured under
    word_bits: int = 32             # plane-layout word bits measured under

    @classmethod
    def from_counters(cls, counters, *, width: int = 32,
                      word_bits: int = 32) -> "WorkloadProfile":
        """Extract a profile from a counter window.

        ``counters`` is a :class:`~repro_torch.telemetry.CounterBank` (e.g.
        ``Device.counters``, or a ``delta`` between two snapshots), its
        ``as_dict()`` payload, or a plain ``{name: value}`` mapping.
        Raises ``ValueError`` when the window recorded no dataplane ops —
        engine counters populate only while a tracer is attached, so an
        empty window almost always means the workload ran outside
        ``pum.profile()``.
        """
        c, hists = _counters_mapping(counters)
        ops = int(c.get("engine.ops_recorded", 0))
        if ops <= 0:
            raise ValueError(
                "counter window records no dataplane ops "
                "(engine.ops_recorded == 0); run the workload under "
                "pum.profile(dev) (engine counters populate only while "
                "a tracer is attached) or pass an explicit profile")
        flushes = int(c.get("engine.flushes", 0))
        mix = {k[len("engine.op."):]: v / ops
               for k, v in sorted(c.items())
               if k.startswith("engine.op.")}
        lanes_h = hists.get("engine.flush_lanes")
        lanes = (lanes_h["total"] / lanes_h["count"]
                 if lanes_h and lanes_h["count"] else 0.0)
        hits = c.get("engine.pipeline_cache.hit", 0)
        misses = c.get("engine.pipeline_cache.miss", 0)
        lhits = c.get("engine.leaf_cache.hits", 0)
        lmisses = c.get("engine.leaf_cache.misses", 0)
        wall = c.get("wall_ns", 0.0)
        cols = (c.get("row.hit", 0) + c.get("row.miss", 0)
                + c.get("row.conflict", 0))
        return cls(
            ops=ops,
            flushes=flushes,
            ops_per_flush=ops / flushes if flushes else float(ops),
            lanes=lanes,
            op_mix=mix,
            raw_fraction=c.get("engine.raw_ops", 0) / ops,
            cache_hit_rate=(hits / (hits + misses)
                            if hits + misses else 0.0),
            autoflush_ops_fraction=(c.get("engine.autoflush.ops", 0)
                                    / flushes if flushes else 0.0),
            autoflush_memory_fraction=(c.get("engine.autoflush.memory", 0)
                                       / flushes if flushes else 0.0),
            leaf_bytes_per_flush=(c.get("engine.leaf_bytes_staged", 0)
                                  / flushes if flushes else 0.0),
            leaf_cache_hit_rate=(lhits / (lhits + lmisses)
                                 if lhits + lmisses else 0.0),
            bus_utilization=c.get("cmd_bus_utilization", 0.0),
            stall_trrd_fraction=(c.get("stall.trrd_ns", 0.0) / wall
                                 if wall else 0.0),
            stall_tfaw_fraction=(c.get("stall.tfaw_ns", 0.0) / wall
                                 if wall else 0.0),
            row_conflict_ratio=(c.get("row.conflict", 0) / cols
                                if cols else 0.0),
            refresh_fraction=(c.get("refresh.stall_ns", 0.0) / wall
                              if wall else 0.0),
            width=int(width),
            word_bits=int(word_bits),
        )

    @classmethod
    def from_device(cls, dev) -> "WorkloadProfile":
        """Profile from a device's accumulated counters (everything since
        construction / the last ``Device.reset_counters()``)."""
        cfg = dev.config
        return cls.from_counters(dev.counters, width=cfg.width,
                                 word_bits=cfg.resolved_layout().word_bits)

    # -- serialization / identity --------------------------------------- #

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["op_mix"] = dict(sorted(self.op_mix.items()))
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "WorkloadProfile":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    def fingerprint(self) -> str:
        """Stable content hash (sha256 of the canonical JSON): same
        profile => same fingerprint in any process."""
        blob = json.dumps(self.as_dict(), sort_keys=True,
                          separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    def scalar_features(self) -> dict:
        """The scalar feature vector the drift detector compares (op_mix
        is handled separately as a distribution distance)."""
        return {
            "ops_per_flush": self.ops_per_flush,
            "lanes": self.lanes,
            "raw_fraction": self.raw_fraction,
            "cache_hit_rate": self.cache_hit_rate,
            "autoflush_ops_fraction": self.autoflush_ops_fraction,
            "autoflush_memory_fraction": self.autoflush_memory_fraction,
            "leaf_bytes_per_flush": self.leaf_bytes_per_flush,
            "leaf_cache_hit_rate": self.leaf_cache_hit_rate,
            "bus_utilization": self.bus_utilization,
            "stall_trrd_fraction": self.stall_trrd_fraction,
            "stall_tfaw_fraction": self.stall_tfaw_fraction,
            "row_conflict_ratio": self.row_conflict_ratio,
            "refresh_fraction": self.refresh_fraction,
        }

    def __repr__(self) -> str:
        top = sorted(self.op_mix.items(), key=lambda kv: -kv[1])[:3]
        mix = "+".join(f"{k}:{v:.0%}" for k, v in top)
        return (f"WorkloadProfile(ops={self.ops}, flushes={self.flushes}, "
                f"depth={self.ops_per_flush:.1f}, lanes={self.lanes:.0f}, "
                f"raw={self.raw_fraction:.0%}, mix={mix})")
