"""PULSAR core of the port: the cost plane and the engine.

Layers (bottom-up), each a copy of its ``repro.core`` counterpart:
  geometry/profiles  — DRAM organization + manufacturer behavior,
  timing/commands    — DDR4 timings, violated-timing PuM command programs,
  replication/pulsar — input replication plans + buddy packing,
  analog             — the charge-sharing Monte-Carlo model,
  cost_model/charact — closed-form costs, tabulated and Monte-Carlo
                       success rates,
  engine             — the record/flush engine behind ``repro_torch.pum``.

Modules are imported by path (``from repro_torch.core.engine import ...``);
this package imports nothing eagerly.
"""
