"""PULSAR core of the port: the cost plane and the engine.

Layers (bottom-up), each a copy of its ``repro.core`` counterpart:
  geometry/profiles  — DRAM organization + manufacturer behavior,
  timing/commands    — DDR4 timings, violated-timing PuM command programs,
  replication/pulsar — input replication plans + buddy packing,
  cost_model/charact — closed-form costs, tabulated success rates,
  engine             — the record/flush engine behind ``repro_torch.pum``.

Modules are imported by path (``from repro_torch.core.engine import ...``);
this package imports nothing eagerly.
"""
