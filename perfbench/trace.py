"""The traced stretch of a ``--trace 1`` run: ``torch.profiler`` over
the CUDA activity, read back from its Chrome trace.

Busy time is the union of the device's kernel, copy and set intervals;
the traced window is the stretch's host-clock length. Idle gaps are
charged to the host span (the program's spans and the harness's own)
open at the gap's middle. Host spans are placed on the trace's clock by
a ``torch.cuda._sleep`` kernel launched just after a host-clock read."""

from __future__ import annotations

import collections
import json
import os
import tempfile
import time

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}


class Stretch:
    """Context manager: profiles the card while open; then ``read(spans)``
    gives busy seconds, the window, the top device operations and the
    idle gaps by host span."""

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self._torch = torch
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize()
        self.anchor_ns = time.perf_counter_ns()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        self.t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self._torch.cuda.synchronize()
        self.t1_ns = time.perf_counter_ns()
        self.prof.__exit__(*exc)
        return False

    def events(self) -> list[dict]:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path, encoding="utf-8") as f:
                data = json.load(f)
        finally:
            os.unlink(path)
        evs = data["traceEvents"] if isinstance(data, dict) else data
        return [e for e in evs if e.get("ph") == "X"
                and e.get("cat") in DEVICE_CATS]

    def read(self, spans: list[tuple[str, int, int]]) -> dict:
        """``spans``: (name, t0_ns, t1_ns) on the host clock."""
        evs = self.events()
        anchor = [e for e in evs if "sleep" in e["name"].lower()
                  or "spin" in e["name"].lower()]
        offset_us = (anchor[0]["ts"] - self.anchor_ns / 1e3) if anchor else None
        lo = self.t0_ns / 1e3 + (offset_us or 0.0)
        hi = self.t1_ns / 1e3 + (offset_us or 0.0)
        iv = sorted((max(e["ts"], lo), min(e["ts"] + e["dur"], hi), e["name"])
                    for e in evs if e not in anchor)
        iv = [x for x in iv if x[1] > x[0]]
        busy_us, by_op = 0.0, collections.Counter()
        merged: list[list[float]] = []
        for a, b, name in iv:
            by_op[name] += b - a
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        busy_us = sum(b - a for a, b in merged)
        gaps = []
        edge = lo
        for a, b in merged:
            if a > edge:
                gaps.append((edge, a))
            edge = max(edge, b)
        if hi > edge:
            gaps.append((edge, hi))
        by_span = collections.Counter()
        if offset_us is not None:
            hs = sorted(((t0 / 1e3 + offset_us, t1 / 1e3 + offset_us, n)
                         for n, t0, t1 in spans), key=lambda s: s[1] - s[0])
            for a, b in gaps:
                mid = (a + b) / 2
                # the innermost (shortest) span open at the gap's middle
                name = next((n for s0, s1, n in hs if s0 <= mid <= s1),
                            "outside any span")
                by_span[name] += b - a
        return {"busy_s": busy_us / 1e6,
                "window_s": (self.t1_ns - self.t0_ns) / 1e9,
                "device_ops": [[n[:120], us / 1e6]
                               for n, us in by_op.most_common(10)],
                "idle_gaps": [[n, us / 1e6]
                              for n, us in by_span.most_common(10)],
                "n_device_events": len(iv)}
