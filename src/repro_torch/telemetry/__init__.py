"""repro_torch.telemetry — zero-overhead-when-disabled observability.

* :class:`CounterBank` — named monotonic counters + log2-bucket
  histograms (the engine's flush counters).
* :class:`Tracer` / :data:`NULL_TRACER` — span context managers around
  the fused pipeline's flush phases, exportable as Chrome trace-event
  JSON (opens in Perfetto).
"""

from repro_torch.telemetry.counters import CounterBank
from repro_torch.telemetry.tracer import NULL_TRACER, Span, Tracer

__all__ = ["CounterBank", "NULL_TRACER", "Span", "Tracer"]
