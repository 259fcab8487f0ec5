"""Refresh generation (LiteDRAM/gram ``Refresher`` analogue).

Every tREFI the refresher requests rank ownership.  The multiplexer lets
in-flight PuM sequences drain (a violated-timing APA cannot be split), stops
launching new sequences, and then grants the rank: the refresher issues a
precharge-all (tRP) followed by one or more REFs (tRFC each), a rank-wide
lockout during which no bank may issue.  ``postponing`` batches up to N
requests into one lockout (JEDEC allows postponing up to 8 REFs).
"""

from __future__ import annotations

from repro_torch.core.timing import DramTimings


class Refresher:
    def __init__(self, timings: DramTimings, trefi: float | None = None,
                 trfc: float | None = None, postponing: int = 1,
                 enabled: bool = True):
        assert 1 <= postponing <= 8
        self.t = timings
        self.trefi = timings.trefi if trefi is None else trefi
        self.trfc = timings.trfc if trfc is None else trfc
        self.postponing = postponing
        self.enabled = enabled
        if enabled and self.trefi * postponing <= self.lockout_ns:
            raise ValueError(
                f"tREFI*postponing ({self.trefi * postponing}ns) must exceed "
                f"the refresh lockout ({self.lockout_ns}ns); the rank would "
                f"do nothing but refresh")
        self.next_due = self.trefi * postponing
        self.n_refreshes = 0
        self.busy_ns = 0.0
        self.windows: list[tuple[float, float]] = []

    @property
    def lockout_ns(self) -> float:
        """Precharge-all + the batched REFs."""
        return self.t.trp + self.trfc * self.postponing

    def blocks(self, when: float) -> bool:
        """True if a *new* sequence starting at ``when`` must wait for REF."""
        return self.enabled and when >= self.next_due - 1e-9

    def execute(self, start: float) -> float:
        """Run the refresh lockout starting at ``start``; returns its end."""
        end = start + self.lockout_ns
        self.windows.append((start, end))
        self.n_refreshes += self.postponing
        self.busy_ns += end - start
        # Periodic tREFI schedule; never re-arm inside the lockout itself.
        self.next_due = max(self.next_due + self.trefi * self.postponing, end)
        return end
