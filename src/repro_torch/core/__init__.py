"""PULSAR core of the port: the cost plane, the engine and the chip model.

Layers (bottom-up), each a copy of its ``repro.core`` counterpart:
  geometry/profiles  — DRAM organization + manufacturer behavior,
  decoder            — hierarchical row decoder, simultaneous activation sets,
  timing/commands    — DDR4 timings, violated-timing PuM command programs,
  analog             — the charge-sharing Monte-Carlo model,
  chip               — bit-exact logical PuM state machine, its bank payload
                       a tensor on a torch device,
  replication/pulsar — input replication plans + staged MAJ execution,
  layout/alu         — vertical data layout + dual-rail bit-serial ALU,
  cost_model/charact — closed-form costs, tabulated and Monte-Carlo
                       success rates,
  destruction        — cold-boot content destruction use case,
  engine             — the record/flush engine behind ``repro_torch.pum``.

The names the reference package exports resolve on first access (``from
repro_torch.core import PulsarChip``); importing the package itself
imports no module.
"""

from __future__ import annotations

import importlib

_EXPORTS = {
    "BitSerialAlu": "alu", "Vec": "alu",
    "SuccessRateDb": "charact", "default_db": "charact",
    "PulsarChip": "chip", "majority_bits": "chip",
    "CostModel": "cost_model", "MICROBENCHES": "cost_model",
    "OpCost": "cost_model",
    "RowDecoder": "decoder",
    "PulsarEngine": "engine",
    "DramGeometry": "geometry", "PAPER_MODULE": "geometry",
    "TEST_GEOMETRY": "geometry",
    "MFR_H": "profiles", "MFR_M": "profiles", "MFR_S": "profiles",
    "PROFILES": "profiles", "MfrProfile": "profiles",
    "PulsarExecutor": "pulsar", "build_region": "pulsar",
    "ReplicationPlan": "replication", "fracdram_plan": "replication",
    "plan": "replication",
    "DDR4_2400": "timing", "DramTimings": "timing",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)
