"""repro_torch.telemetry — zero-overhead-when-disabled observability.

* :class:`CounterBank` — named monotonic counters + log2-bucket
  histograms (the engine's flush counters and the derived controller
  counters).
* :func:`derive_controller_counters` — post-hoc replay of a
  ``ScheduleResult``/``MuxResult`` command trace into bus-utilization,
  row-buffer, stall and refresh counters; :func:`derive_port_counters`
  extends it to a ``CrossbarTrace``'s per-port attribution, and
  :func:`check_timing_invariants` audits any trace against the rank-wide
  tRRD/tFAW/tCCD/bus/refresh contract (empty list = clean).
* :class:`Tracer` / :data:`NULL_TRACER` — span context managers around
  the fused pipeline's flush phases, exportable as Chrome trace-event
  JSON (opens in Perfetto).
"""

from repro_torch.telemetry.counters import (CounterBank,
                                            check_timing_invariants,
                                            derive_controller_counters,
                                            derive_port_counters)
from repro_torch.telemetry.tracer import NULL_TRACER, Span, Tracer

__all__ = [
    "CounterBank",
    "NULL_TRACER",
    "Span",
    "Tracer",
    "check_timing_invariants",
    "derive_controller_counters",
    "derive_port_counters",
]
