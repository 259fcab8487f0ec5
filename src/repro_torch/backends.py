"""Pluggable backend registry: capability lookup for dataplane evaluators.

The port's copy of ``repro.backends``. Every evaluator is a registered
:class:`BackendSpec` and call sites look capabilities up:

* the engine resolves its ``backend=`` name to an **eager dataplane**
  builder (capability ``"eager"``); ``"fast"`` computes on packed NumPy
  words on the host, ``"sim"`` on the bit-exact chip model (a small
  simulated DRAM region whose bank payload lies on the engine's
  ``torch.device``, with the dual-rail bit-serial ALU on top);
* the fused pipeline resolves a :class:`FusedProgram` to a **fused
  evaluator** (capability ``"fused"``) by :func:`select_backend` — the
  highest-priority backend available *on the requesting device* whose
  ``max_width`` covers the program and whose ``layouts`` include the
  program's plane layout.

Availability is a property of the Device's own ``torch.device``, never a
global probe: a CUDA device selects ``vertical-cuda`` (the hand-written
bit-transpose and fused-program kernels), a CPU device ``words-torch``.
``ref-vertical`` (the plain vertical version of both kernels) is never
auto-selected and is requestable by name.

Builders import lazily, so the registry can be imported from anywhere in
the package without cycles.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable

# Reference backends that later slices of the port bring.
_LATER_SLICES = {
    "shard-words": "the LM/distributed slice (multi-GPU word-axis "
                   "pipeline)",
}


def _never(device) -> bool:
    return False


@dataclasses.dataclass(frozen=True)
class BackendSpec:
    """One registered backend.

    ``builder`` signature depends on capability:

    * ``"eager"`` backends: ``builder(engine) -> None | alu`` — called
      at ``PulsarEngine`` construction; ``None`` selects the packed-NumPy
      word dataplane, an ALU-protocol object (``words``, ``load``,
      ``store``, ``free`` and the ops, as ``BitSerialAlu`` has them) routes
      the engine's eager binary ops through it.
    * ``"fused"`` backends: ``builder(program, donate=...)
      -> fn(*leaves) -> tuple(outs)`` — called (and cached) per program
      structure by ``fused_program.get_pipeline``. Leaves and outputs are
      flat int32 tensors of packed horizontal words, all on one device;
      the pipeline computes where its leaves lie.

    ``available(device)`` gates automatic selection for a
    ``torch.device``; an unavailable backend can still be requested by
    name. ``max_width`` bounds the element width, ``layouts`` declares
    the plane-layout word sizes (32/64) the pipelines consume,
    ``priority`` breaks ties (higher wins).
    """
    name: str
    builder: Callable[..., Any]
    capabilities: frozenset[str]
    max_width: int = 32
    priority: int = 0
    available: Callable[[Any], bool] = dataclasses.field(
        default_factory=lambda: lambda device: True)
    layouts: frozenset[int] = frozenset({32})


_REGISTRY: dict[str, BackendSpec] = {}


def register_backend(name: str, builder: Callable[..., Any], *,
                     capabilities=("fused",), max_width: int = 32,
                     priority: int = 0,
                     available: Callable[[Any], bool] | None = None,
                     layouts=(32,)) -> BackendSpec:
    """Register (or replace) a backend under ``name`` and return its spec.

    Each registration gets its own default ``available`` function, so a
    re-registration with the same builder and knobs still gives a spec
    unequal to the old one, and the pipeline cache builds anew for it.
    The built-in names are ``fast``, ``sim``, ``words-torch``,
    ``vertical-cuda``,
    ``ref-vertical`` and their ``-64`` layout variants."""
    knobs = {} if available is None else {"available": available}
    spec = BackendSpec(name=name, builder=builder,
                       capabilities=frozenset(capabilities),
                       max_width=max_width, priority=priority,
                       layouts=frozenset(int(b) for b in layouts), **knobs)
    _REGISTRY[name] = spec
    return spec


def unregister_backend(name: str) -> None:
    """Remove a registered backend (mainly for tests)."""
    _REGISTRY.pop(name, None)


def get_backend(name: str) -> BackendSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        if name in _LATER_SLICES:
            raise NotImplementedError(
                f"backend {name!r} is not ported yet: it comes with "
                f"{_LATER_SLICES[name]}") from None
        raise KeyError(
            f"unknown backend {name!r}; registered: "
            f"{sorted(_REGISTRY)} (register_backend() adds new ones)"
        ) from None


def available_backends(capability: str | None = None) -> tuple[str, ...]:
    """Names of registered backends, optionally filtered by capability
    (registration order; includes ones unavailable on any device)."""
    return tuple(n for n, s in _REGISTRY.items()
                 if capability is None or capability in s.capabilities)


# Selection overrides: capability -> pinned backend name, consulted by
# select_backend before the priority scan. A pin only wins when its spec
# satisfies the query's capability/width/layout constraints.
_SELECTION_OVERRIDE: dict[str, str] = {}


def set_selection_override(capability: str, name: str | None) -> None:
    """Pin (or with ``None`` unpin) the backend ``select_backend``
    returns for single-capability ``capability`` queries. Prefer the
    scoped :func:`selection_override` context manager."""
    if name is None:
        _SELECTION_OVERRIDE.pop(capability, None)
    else:
        get_backend(name)  # loud on unknown names
        _SELECTION_OVERRIDE[capability] = name


def get_selection_override(capability: str) -> str | None:
    """The currently pinned backend name for ``capability`` (or None)."""
    return _SELECTION_OVERRIDE.get(capability)


@contextlib.contextmanager
def selection_override(capability: str, name: str | None):
    """Scoped :func:`set_selection_override`: pin ``name`` for the
    duration of the block, restoring the previous pin on exit."""
    prev = _SELECTION_OVERRIDE.get(capability)
    set_selection_override(capability, name)
    try:
        yield
    finally:
        set_selection_override(capability, prev)


def select_backend(*, require, device, width: int | None = None,
                   layout=None) -> BackendSpec:
    """Capability lookup: the highest-priority backend *available on
    ``device``* (a ``torch.device`` or its name) whose capabilities cover
    ``require``, whose ``max_width`` covers ``width``, and whose declared
    ``layouts`` include ``layout`` (a word-bit count or a
    ``PlaneLayout``; ``None`` skips the filter). A
    :func:`set_selection_override` pin for the capability takes
    precedence when it satisfies the same constraints. Raises
    ``LookupError`` when nothing matches."""
    import torch

    device = torch.device(device)
    need = frozenset((require,) if isinstance(require, str) else require)
    wb = getattr(layout, "word_bits", layout)
    if len(need) == 1:
        pinned = _SELECTION_OVERRIDE.get(next(iter(need)))
        if pinned is not None:
            spec = _REGISTRY.get(pinned)
            if spec is not None and need <= spec.capabilities \
                    and (width is None or spec.max_width >= width) \
                    and (wb is None or wb in spec.layouts):
                return spec
    best: BackendSpec | None = None
    for spec in _REGISTRY.values():
        if not need <= spec.capabilities:
            continue
        if width is not None and spec.max_width < width:
            continue
        if wb is not None and wb not in spec.layouts:
            continue
        if not spec.available(device):
            continue
        if best is None or spec.priority > best.priority:
            best = spec
    if best is None:
        raise LookupError(
            f"no backend available on {device} with capabilities "
            f"{sorted(need)}"
            + (f" at width {width}" if width is not None else "")
            + (f" on the {wb}-bit plane layout" if wb is not None else "")
            + f"; registered: {sorted(_REGISTRY)}")
    return best


# --------------------------------------------------------------------- #
# Built-in backends. Builders import lazily: the registry stays
# import-cycle-free and costs nothing until a backend is actually used.
# --------------------------------------------------------------------- #


def _build_fast_dataplane(engine) -> None:
    """Packed-NumPy word dataplane: the engine computes ops directly on
    uint64 ndarrays on the host (and fuses through the lazy op graph when
    asked)."""
    return None


def _build_sim_dataplane(engine):
    """Bit-exact chip-model dataplane: a small simulated DRAM region on the
    engine's device with the dual-rail bit-serial ALU on top (cycle-exact
    command accounting)."""
    from repro_torch.core.alu import BitSerialAlu
    from repro_torch.core.chip import PulsarChip
    from repro_torch.core.decoder import RowDecoder
    from repro_torch.core.geometry import DramGeometry
    from repro_torch.core.pulsar import PulsarExecutor
    geom = DramGeometry(row_bits=min(engine.row_bits, 2048),
                        rows_per_subarray=512, subarrays_per_bank=2,
                        banks=2)
    chip = PulsarChip(geom, engine.profile, seed=engine.seed,
                      device=engine.device)
    chip.decoder = RowDecoder(geom, engine.profile, None)  # perfect yield
    return BitSerialAlu(PulsarExecutor(chip, 0, 0), width=engine.width)


def _build_words_pipeline(program, donate: bool = False):
    from repro_torch.kernels import fused_program
    return fused_program.build_words_pipeline(program, donate=donate)


def _build_cuda_pipeline(program, donate: bool = False):
    from repro_torch.kernels import fused_program
    return fused_program.build_vertical_pipeline(
        program, use_kernels=True, donate=donate)


def _build_ref_vertical_pipeline(program, donate: bool = False):
    from repro_torch.kernels import fused_program
    return fused_program.build_vertical_pipeline(
        program, use_kernels=False, donate=donate)


def on_cpu(device) -> bool:
    return device.type == "cpu"


def on_cuda(device) -> bool:
    return device.type == "cuda"


register_backend("fast", _build_fast_dataplane,
                 capabilities=("eager",), max_width=64, priority=10,
                 layouts=(32, 64))
register_backend("sim", _build_sim_dataplane,
                 capabilities=("eager", "sim"), max_width=64,
                 layouts=(32, 64))
register_backend("words-torch", _build_words_pipeline,
                 capabilities=("fused",), max_width=32, priority=10,
                 available=on_cpu)
register_backend("vertical-cuda", _build_cuda_pipeline,
                 capabilities=("fused", "vertical"), max_width=32,
                 priority=20, available=on_cuda)
# The plain vertical version of both kernels: never auto-selected (it
# exists to validate the other two), but requestable by name.
register_backend("ref-vertical", _build_ref_vertical_pipeline,
                 capabilities=("fused", "vertical", "debug"), max_width=32,
                 priority=-10, available=_never)

# 64-bit plane-layout evaluators: the same builders over the wider layout.
register_backend("words-torch-64", _build_words_pipeline,
                 capabilities=("fused",), max_width=64, priority=10,
                 available=on_cpu, layouts=(64,))
register_backend("vertical-cuda-64", _build_cuda_pipeline,
                 capabilities=("fused", "vertical"), max_width=64,
                 priority=20, available=on_cuda, layouts=(64,))
register_backend("ref-vertical-64", _build_ref_vertical_pipeline,
                 capabilities=("fused", "vertical", "debug"), max_width=64,
                 priority=-10, available=_never, layouts=(64,))
