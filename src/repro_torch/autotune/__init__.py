"""repro_torch.autotune — telemetry-driven adaptive execution planning.

The port's copy of ``repro.autotune``, closing the measure → decide →
apply loop over the port's telemetry:

* **measure** — :class:`WorkloadProfile` summarizes a
  :class:`~repro_torch.telemetry.CounterBank` window (op mix, graph
  depth, lane count, pipeline-cache hit rate, raw-bitmap share, leaf
  bytes staged, plus the controller's bus-utilization / stall-split /
  row-conflict / refresh counters when present) into a frozen,
  JSON-round-trippable feature vector;
* **decide** — :class:`CostModel` scores candidate configs against a
  profile with the roofline decomposition, anchored to the H100's memory
  rate and peak (``cost.HBM_BW``, ``cost.PEAK_FLOPS``), and
  :class:`Tuner` exhaustively searches the discrete space — fused
  backend available on the config's device × plane layout × auto-flush
  bounds × REF postponing × crossbar lookahead — freezing the
  deterministic winner into a :class:`TunedPlan`;
* **apply** — ``Device.autotune()`` applies a plan's *execution* knobs
  live (bit-exact, ``EngineStats``-identical by construction; the
  cost-plane ``ref_postponing`` recommendation is an explicit opt-in),
  and :class:`OnlineAutotuner` re-tunes from per-window counter deltas
  when the :class:`DriftDetector` fires (exploit) or on a fixed cadence
  (explore).

``TunedPlan`` / ``Tuner`` / ``WorkloadProfile`` are re-exported on the
public ``repro_torch.pum`` surface.
"""

from repro_torch.autotune.cost import CostModel, Estimate
from repro_torch.autotune.profile import WorkloadProfile
from repro_torch.autotune.tuner import (DriftDetector, OnlineAutotuner,
                                        SearchSpace, TunedPlan, Tuner)

__all__ = [
    "CostModel",
    "DriftDetector",
    "Estimate",
    "OnlineAutotuner",
    "SearchSpace",
    "TunedPlan",
    "Tuner",
    "WorkloadProfile",
]
