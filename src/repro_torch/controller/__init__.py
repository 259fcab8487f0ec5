"""Bank-parallel PuM memory controller (paper §7: multi-bank parallelism).

The port's copy of ``repro.controller``: a discrete-event simulation in
pure Python that runs on the host, with no kernel of its own. It prices
the engine's ops under ``controller="auto"`` and schedules concurrent
client streams through the crossbar.

Discrete-event analogue of a LiteDRAM/gram-style controller:

  * :class:`~repro_torch.controller.bank_machine.BankMachine` — per-bank FSM with
    open-row tracking, an open/closed-page precharge policy, and a queue of
    PuM command programs (violated-timing sequences are atomic units).
  * :class:`~repro_torch.controller.multiplexer.CommandMultiplexer` — round-robin +
    refresh-priority arbiter for the shared command bus, enforcing the
    rank-wide constraints (tFAW, tRRD, tCCD, one command per tCK).
  * :class:`~repro_torch.controller.refresher.Refresher` — tREFI/tRFC REF injection
    that stalls new PuM sequences while letting in-flight ones drain.
  * :class:`~repro_torch.controller.controller.MemoryController` — the facade:
    accepts ``Cmd`` programs tagged with target banks and returns a
    cycle-accounted, ``ScheduleResult``-compatible trace.
  * :class:`~repro_torch.controller.crossbar.Crossbar` — N client ports feeding
    the bank machines through a lookahead feeder with per-bank round-robin
    grants (LiteDRAM crossbar analogue); ``CrossbarTrace`` attributes every
    issued command back to its port for post-hoc fairness audits.
"""

from repro_torch.controller.bank_machine import BankMachine, BankState
from repro_torch.controller.controller import (BankBatchCost, ControllerTrace,
                                         MemoryController, retarget_program)
from repro_torch.controller.crossbar import ClientPort, Crossbar, CrossbarTrace
from repro_torch.controller.multiplexer import CommandMultiplexer
from repro_torch.controller.refresher import Refresher

__all__ = [
    "BankMachine", "BankState", "CommandMultiplexer", "Refresher",
    "MemoryController", "ControllerTrace", "BankBatchCost",
    "retarget_program", "Crossbar", "ClientPort", "CrossbarTrace",
]
