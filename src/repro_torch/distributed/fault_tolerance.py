"""Fault tolerance: heartbeats, straggler detection, supervised restart,
elastic re-mesh planning.

Scaled-out posture (1000+ nodes): every worker ticks a heartbeat; the
monitor flags missing ticks (dead node -> restart from checkpoint with a
shrunk mesh) and per-step-time z-score outliers (straggler -> report; the
scheduler can re-shard around it). In one process the mechanisms are
exercised by tests (thread workers, killed child processes) — the same
control logic a multi-host deployment would run on the coordinator. The
port's copy of ``repro.distributed.fault_tolerance`` (pure Python).
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys
import threading
import time


@dataclasses.dataclass
class WorkerState:
    last_beat: float
    step_times: list = dataclasses.field(default_factory=list)


class HeartbeatMonitor:
    def __init__(self, timeout_s: float = 5.0, window: int = 32,
                 straggler_factor: float = 2.0):
        self.timeout_s = timeout_s
        self.window = window
        self.straggler_factor = straggler_factor
        self.workers: dict[str, WorkerState] = {}
        self._lock = threading.Lock()

    def beat(self, worker: str, step_time_s: float | None = None) -> None:
        with self._lock:
            st = self.workers.setdefault(worker, WorkerState(time.time()))
            st.last_beat = time.time()
            if step_time_s is not None:
                st.step_times.append(step_time_s)
                st.step_times = st.step_times[-self.window:]

    def dead_workers(self, now: float | None = None) -> list[str]:
        # `now is None`, not truthiness: now=0.0 is a legitimate epoch in
        # tests/replays and must not silently become the wall clock.
        now = time.time() if now is None else now
        with self._lock:
            return [w for w, st in self.workers.items()
                    if now - st.last_beat > self.timeout_s]

    def stragglers(self) -> list[str]:
        """Workers whose mean step time exceeds straggler_factor x the fleet
        median (median-based: robust to the straggler itself, and meaningful
        at any fleet size, unlike a z-score which saturates at small n)."""
        with self._lock:
            means = {w: sum(st.step_times) / len(st.step_times)
                     for w, st in self.workers.items() if st.step_times}
        if len(means) < 3:
            return []
        vals = sorted(means.values())
        med = vals[len(vals) // 2]
        return [w for w, v in means.items()
                if v > self.straggler_factor * med]


def plan_elastic_mesh(healthy_devices: int, model_parallel: int
                      ) -> tuple[int, int]:
    """Largest (data, model) mesh fitting the healthy-device count with the
    model axis preserved (TP degree is fixed by memory); DP shrinks."""
    if healthy_devices < model_parallel:
        raise RuntimeError(
            f"not enough devices ({healthy_devices}) for TP={model_parallel}")
    data = healthy_devices // model_parallel
    return data, model_parallel


class Supervisor:
    """Restart-on-failure loop for a training child process.

    The child checkpoints every K steps; on a non-zero exit the supervisor
    relaunches it with --resume (and, if devices changed, the new mesh) —
    the checkpoint manager reshards on restore."""

    def __init__(self, argv: list[str], max_restarts: int = 3):
        self.argv = argv
        self.max_restarts = max_restarts
        self.restarts = 0

    def run(self) -> int:
        while True:
            proc = subprocess.run([sys.executable] + self.argv)
            if proc.returncode == 0:
                return 0
            self.restarts += 1
            if self.restarts > self.max_restarts:
                return proc.returncode
