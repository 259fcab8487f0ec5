"""repro_torch.reliability — the closed reliability loop of the port.

Calibrate a simulated chip into a persistent per-bank/per-subarray/
per-column :class:`ReliabilityMap` (the analog Monte-Carlo, on the
charge-sharing kernel on a CUDA device), then hand it to a device via
``pum.EngineConfig(reliability=ReliabilityConfig(map=..., inject=True))``:
planning picks the fig-11 replication factor per operation from the map,
and execution corrects injected faults by temporal replication voting (the
MAJ-N kernel on a CUDA device) with bounded retry escalation, degrading to
the clean execution as a last resort.
"""

from repro_torch.reliability.calibration import (DEFAULT_CONFIGS, P_STABLE,
                                                 ReliabilityMap, calibrate)
from repro_torch.reliability.faults import FaultInjector, majority_vote
from repro_torch.reliability.plane import ReliabilityConfig, ReliabilityPlane

__all__ = [
    "DEFAULT_CONFIGS",
    "P_STABLE",
    "FaultInjector",
    "ReliabilityConfig",
    "ReliabilityMap",
    "ReliabilityPlane",
    "calibrate",
    "majority_vote",
]
