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
* telemetry (:func:`profile`, :class:`Tracer`, :class:`CounterBank`).
"""

from repro_torch.backends import (BackendSpec, available_backends,
                                  get_backend, register_backend,
                                  select_backend, unregister_backend)
from repro_torch.core.engine import EngineStats
from repro_torch.kernels.plane_layout import (LAYOUT32, LAYOUT64,
                                              PlaneLayout, get_layout)
from repro_torch.pum.api import (Device, PumArray, asarray, default_device,
                                 device, profile)
from repro_torch.pum.config import EngineConfig
from repro_torch.telemetry import CounterBank, Tracer

__all__ = [
    "BackendSpec",
    "CounterBank",
    "Device",
    "EngineConfig",
    "EngineStats",
    "LAYOUT32",
    "LAYOUT64",
    "PlaneLayout",
    "PumArray",
    "Tracer",
    "asarray",
    "available_backends",
    "default_device",
    "device",
    "get_backend",
    "get_layout",
    "profile",
    "register_backend",
    "select_backend",
    "unregister_backend",
]
