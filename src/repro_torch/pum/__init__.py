"""repro_torch.pum — the public API of the PyTorch/CUDA port.

The same surface as ``repro.pum`` for the slice ported so far:

* :class:`PumArray` — ndarray-like handle with operator overloading
  (``& | ^ + - * // % < > <= >=``, ``divmod()``, ``popcount()``,
  ``reduce_bits()``);
* :class:`Device` + :class:`EngineConfig` — configuration and lifecycle
  (``pum.device(...)`` as a context manager scopes the default device and
  flushes on exit). ``EngineConfig.device`` defaults to ``"cuda"``: fused
  flushes run the hand-written CUDA kernels; ``device="cpu"`` runs the
  word-domain evaluator;
* the backend registry (:func:`register_backend` and friends);
* telemetry (:func:`profile`, :class:`Tracer`, :class:`CounterBank`);
* concurrency (``Device.flush_async`` -> :class:`FlushHandle`,
  ``Device.capture`` -> :class:`CapturedProgram`, ``Device.client``) —
  N client contexts share one device, flushes dispatch off the caller's
  thread double-buffered, and a captured program replays its compiled
  pipeline with zero re-recording;
* reliability (:func:`calibrate`, :class:`ReliabilityMap`,
  :class:`ReliabilityConfig`) — calibrate a simulated chip into a
  per-bank/per-subarray/per-column map on the charge-sharing kernel, then
  ``EngineConfig(reliability=...)`` (or ``Device.calibrate()``) plans
  replication from it and, with ``inject=True``, corrects injected faults
  by replica voting on the MAJ-N kernel;
* autotuning (``Device.autotune`` -> :class:`TunedPlan`, :class:`Tuner`,
  :class:`WorkloadProfile`) — measure a workload under :func:`profile`,
  search the execution knobs over the backends of the device's
  ``torch.device`` and apply the winner live; outputs and
  ``EngineStats`` stay bit-identical.
"""

from repro_torch.autotune import TunedPlan, Tuner, WorkloadProfile
from repro_torch.backends import (BackendSpec, available_backends,
                                  get_backend, register_backend,
                                  select_backend, unregister_backend)
from repro_torch.core.engine import EngineStats, FlushHandle
from repro_torch.kernels.plane_layout import (LAYOUT32, LAYOUT64,
                                              PlaneLayout, get_layout)
from repro_torch.pum.api import (Device, PumArray, as_device, asarray,
                                 default_device, device, profile)
from repro_torch.pum.capture import CapturedProgram
from repro_torch.pum.config import EngineConfig
from repro_torch.reliability import (ReliabilityConfig, ReliabilityMap,
                                     calibrate)
from repro_torch.telemetry import CounterBank, Tracer

__all__ = [
    "BackendSpec",
    "CapturedProgram",
    "CounterBank",
    "Device",
    "EngineConfig",
    "EngineStats",
    "FlushHandle",
    "LAYOUT32",
    "LAYOUT64",
    "PlaneLayout",
    "PumArray",
    "ReliabilityConfig",
    "ReliabilityMap",
    "Tracer",
    "TunedPlan",
    "Tuner",
    "WorkloadProfile",
    "as_device",
    "asarray",
    "available_backends",
    "calibrate",
    "default_device",
    "device",
    "get_backend",
    "get_layout",
    "profile",
    "register_backend",
    "select_backend",
    "unregister_backend",
]
