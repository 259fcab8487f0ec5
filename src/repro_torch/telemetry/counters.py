"""CounterBank: named monotonic counters + log2-bucket histograms.

The one counter container of the port: engine flush counters render
through the same ``as_dict()``/``__repr__`` schema as the reference's.
The post-hoc controller counter derivations (``derive_*``,
``check_timing_invariants``) arrive with the controller slice.

Units: every counter name carries its unit as a suffix where one applies
(``*_ns`` nanoseconds, ``*_j`` joules); unsuffixed counters are plain
event counts. Histogram observations are raw values bucketed by power of
two (``observe``).
"""

from __future__ import annotations

import math


class CounterBank:
    """Named monotonic counters plus power-of-two value histograms.

    ``inc(name, v)`` accumulates a counter; ``observe(name, v)`` records a
    sample into a histogram (count / total / min / max / log2 buckets —
    the shape a latency distribution needs without storing samples).
    Everything renders through :meth:`as_dict` with plain-JSON types.
    """

    __slots__ = ("_counters", "_hists")

    def __init__(self):
        self._counters: dict[str, float] = {}
        self._hists: dict[str, dict] = {}

    # -- counters ------------------------------------------------------- #

    def inc(self, name: str, value: float = 1) -> None:
        self._counters[name] = self._counters.get(name, 0) + value

    def get(self, name: str, default: float = 0) -> float:
        return self._counters.get(name, default)

    def __getitem__(self, name: str) -> float:
        return self._counters[name]

    def __contains__(self, name: str) -> bool:
        return name in self._counters

    def __len__(self) -> int:
        return len(self._counters) + len(self._hists)

    # -- histograms ----------------------------------------------------- #

    def observe(self, name: str, value: float) -> None:
        """Record one sample into the ``name`` histogram (log2 buckets:
        bucket ``k`` counts samples in ``(2**(k-1), 2**k]``; non-positive
        samples land in bucket 0)."""
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = {"count": 0, "total": 0.0,
                                     "min": math.inf, "max": -math.inf,
                                     "buckets": {}}
        h["count"] += 1
        h["total"] += value
        h["min"] = min(h["min"], value)
        h["max"] = max(h["max"], value)
        k = 0 if value <= 1 else math.ceil(math.log2(value))
        h["buckets"][k] = h["buckets"].get(k, 0) + 1

    def histogram(self, name: str) -> dict:
        """Snapshot of one histogram: ``count``/``total``/``min``/``max``/
        ``mean``/``buckets`` (bucket key = log2 upper bound)."""
        h = self._hists[name]
        return dict(h, mean=(h["total"] / h["count"] if h["count"] else 0.0),
                    buckets=dict(h["buckets"]))

    # -- windows -------------------------------------------------------- #

    def snapshot(self) -> "CounterBank":
        """An independent deep copy of the bank's current state — the
        start marker of a measurement window (pair with :meth:`delta`).
        Mutating either bank afterwards never affects the other."""
        s = CounterBank()
        s._counters = dict(self._counters)
        s._hists = {name: {"count": h["count"], "total": h["total"],
                           "min": h["min"], "max": h["max"],
                           "buckets": dict(h["buckets"])}
                    for name, h in self._hists.items()}
        return s

    def delta(self, prev: "CounterBank") -> "CounterBank":
        """This bank minus an earlier :meth:`snapshot` — the counters a
        window accumulated, without resetting the live bank (so
        long-lived devices can be profiled per window: the autotuner's
        drift windows are exactly these deltas). Counters subtract;
        histograms subtract count/total/buckets (their ``mean`` stays
        exact); a window's true ``min``/``max`` are not recoverable from
        two cumulative states, so the live bank's values are kept.
        Zero-change entries are dropped."""
        out = CounterBank()
        for name, v in self._counters.items():
            dv = v - prev._counters.get(name, 0)
            if dv:
                out._counters[name] = dv
        for name, h in self._hists.items():
            p = prev._hists.get(name)
            count = h["count"] - (p["count"] if p else 0)
            if not count:
                continue
            buckets = dict(h["buckets"])
            if p:
                for k, n in p["buckets"].items():
                    buckets[k] = buckets.get(k, 0) - n
            out._hists[name] = {
                "count": count,
                "total": h["total"] - (p["total"] if p else 0.0),
                "min": h["min"], "max": h["max"],
                "buckets": {k: n for k, n in buckets.items() if n},
            }
        return out

    def clear(self) -> None:
        """Reset every counter and histogram **in place** (holders of a
        reference to this bank — the engine, an attached reliability
        plane — keep writing into the same object)."""
        self._counters.clear()
        self._hists.clear()

    # -- aggregate views ------------------------------------------------ #

    def merge(self, other: "CounterBank") -> "CounterBank":
        """Accumulate ``other`` into this bank (counters add; histograms
        combine bucket-wise). Returns self for chaining."""
        for name, v in other._counters.items():
            self.inc(name, v)
        for name, h in other._hists.items():
            mine = self._hists.get(name)
            if mine is None:
                self._hists[name] = {"count": h["count"], "total": h["total"],
                                     "min": h["min"], "max": h["max"],
                                     "buckets": dict(h["buckets"])}
            else:
                mine["count"] += h["count"]
                mine["total"] += h["total"]
                mine["min"] = min(mine["min"], h["min"])
                mine["max"] = max(mine["max"], h["max"])
                for k, n in h["buckets"].items():
                    mine["buckets"][k] = mine["buckets"].get(k, 0) + n
        return self

    def as_dict(self) -> dict:
        """Plain-JSON snapshot: ``{"counters": {...}, "histograms": {...}}``
        (the schema ``BENCH_*.json`` embeds and ``docs/observability.md``
        documents)."""
        return {
            "counters": dict(sorted(self._counters.items())),
            "histograms": {name: self.histogram(name)
                           for name in sorted(self._hists)},
        }

    def __repr__(self) -> str:
        parts = [f"{k}={v:g}" for k, v in sorted(self._counters.items())]
        parts += [f"{k}=hist(n={h['count']})"
                  for k, h in sorted(self._hists.items())]
        body = ", ".join(parts[:8]) + (", ..." if len(parts) > 8 else "")
        return f"CounterBank({body})"
