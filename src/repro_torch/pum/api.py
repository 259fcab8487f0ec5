"""PumArray + Device: the ndarray-like operator frontend over the engine.

The port's copy of ``repro.pum.api``. ``PumArray`` is the one
caller-visible value type: it wraps an eager ndarray or a pending
``LazyArray`` of the fused graph behind operator overloading and
materializes on demand (``to_numpy()`` / ``np.asarray``). ``Device`` owns
the engine an array computes on; used as a context manager it scopes the
default device for :func:`asarray` and flushes pending work on exit.

>>> import numpy as np
>>> import repro_torch.pum as pum
>>> with pum.device(width=8, device="cpu") as dev:
...     x = dev.asarray(np.array([3, 5, 250], np.uint64))
...     y = (x + 6) * x                  # records into the fused graph
>>> y.to_numpy()                         # flushed on scope exit
array([27, 55,  0], dtype=uint64)
>>> q, r = divmod(y, np.array([4, 7, 9], np.uint64))
>>> np.asarray(q), np.asarray(r)         # one restoring-division pass
(array([6, 7, 0], dtype=uint64), array([3, 6, 0], dtype=uint64))
"""

from __future__ import annotations

import contextlib

import numpy as np

from repro_torch.core.engine import LazyArray, PulsarEngine
from repro_torch.pum.config import EngineConfig

# Innermost active `with device(...)` last; module default built lazily.
_ACTIVE: list["Device"] = []
_DEFAULT: "Device | None" = None


class Device:
    """One PuM compute device: an engine plus its configuration.

    Construction goes through :class:`EngineConfig` (keyword overrides
    accepted); the fused evaluator is resolved through the
    ``repro_torch.backends`` registry for the config's ``device``. As a
    context manager the device becomes the scoped default for
    :func:`asarray` and flushes any pending fused graph on exit.
    """

    def __init__(self, config: EngineConfig | None = None, *,
                 _engine: PulsarEngine | None = None, **overrides):
        if config is None:
            config = EngineConfig(**overrides)
        elif overrides:
            config = config.replace(**overrides)
        # The sim backend is per-op by construction (the chip model has no
        # word dataplane to fuse over).
        if config.backend == "sim" and config.fuse:
            config = config.replace(fuse=False)
        # When NO registered fused evaluator supports this width/layout on
        # the device (a pinned fused_backend takes precedence): per-op
        # eager execution instead of refusing to build.
        if config.fuse and config.fused_backend is None:
            from repro_torch.backends import select_backend
            from repro_torch.core.engine import resolve_device
            try:
                select_backend(require="fused",
                               device=resolve_device(config.device),
                               width=config.width,
                               layout=config.resolved_layout())
            except LookupError:
                config = config.replace(fuse=False)
        self.config = config
        self._scalars: dict[tuple, np.ndarray] = {}
        if _engine is not None:  # as_device(): wrap an existing engine
            self.engine = _engine
            return
        self.engine = PulsarEngine(
            mfr=config.mfr, width=config.width,
            row_bits=config.row_bits, banks=config.banks,
            backend=config.backend, success_db=config.success_db,
            use_pulsar=config.use_pulsar, chained=config.chained,
            controller=config.controller, seed=config.seed,
            fuse=config.fuse, flush_threshold=config.flush_threshold,
            flush_memory_bytes=config.flush_memory_bytes,
            donate_leaves=config.donate_leaves, layout=config.layout,
            leaf_cache_bytes=config.leaf_cache_bytes,
            fused_backend=config.fused_backend,
            ref_postponing=config.ref_postponing,
            reliability=config.reliability,
            cmd_buffer_lookahead=config.cmd_buffer_lookahead,
            device=config.device)

    # -- array construction / lifecycle -------------------------------- #

    def asarray(self, x) -> "PumArray":
        """Wrap ``x`` as a :class:`PumArray` on this device (no compute,
        no charge — arrays enter the dataplane when an op consumes them).
        """
        if isinstance(x, PumArray):
            return x if x.device is self else PumArray(self, x.to_numpy())
        return PumArray(self, np.asarray(x, np.uint64))

    def flush(self) -> None:
        """Materialize every pending fused op graph — all client
        contexts, parked retries, and in-flight async flushes (no-op when
        eager or empty; never touches the cost plane)."""
        self.engine.flush_all()

    def flush_async(self):
        """Compile + dispatch the calling context's pending graph off
        this thread (double-buffered: the caller stages the next flush
        while the worker dispatches the current one, under the caller's
        CUDA stream). Returns a :class:`~repro_torch.core.engine.
        FlushHandle`; ``result()`` waits and re-raises a failed dispatch
        after parking the graph for retry, exactly like a failed
        synchronous flush."""
        return self.engine.flush_async()

    def capture(self, fn, name: str | None = None):
        """Capture ``fn(*PumArrays) -> PumArray(s)`` as a
        :class:`~repro_torch.pum.capture.CapturedProgram`: first call per
        input shape records + compiles; later calls replay the compiled
        pipeline with zero re-recording (cost charges replay
        identically)."""
        from repro_torch.pum.capture import CapturedProgram
        return CapturedProgram(self, fn, name=name)

    def client(self, name: str):
        """Scope ops to a named client context (``with dev.client("a"):``)
        — its own recording graph and stats shard, so N logical clients
        share the device without interleaving their programs."""
        return self.engine.client(name)

    def calibrate(self, *, inject: bool = False, attach: bool = True,
                  n_subarrays: int = 4, n_columns: int = 256,
                  n_patterns: int = 8, configs=None,
                  process_variation: float | None = None,
                  seed: int | None = None, save=None, **policy):
        """Profile this device's simulated chip into a
        :class:`~repro_torch.reliability.ReliabilityMap` on the device's
        ``torch.device`` (the charge-sharing kernel on a CUDA device) and
        (by default) attach it: subsequent ops plan their fig-11
        replication factor from the calibrated per-bank/per-subarray
        success rates. With ``inject=True`` the flush-time fault-injection
        + replication-vote/retry loop also turns on (requires a fused
        device). Extra keyword ``policy`` fields (``votes``,
        ``max_attempts``, ``min_margin``, ``target_success``, ``steer``,
        ``flip_scale``, reliability ``seed``) go to the
        :class:`~repro_torch.reliability.ReliabilityConfig`.

        Calibration is seeded from the device config (same device config
        on the same device type => bit-identical map); ``save=`` persists
        the map as ``.npz`` (the reference's format) for reuse via
        ``ReliabilityConfig(map="path.npz")``. The default profile sizes
        are test-scale — production calibration passes larger
        ``n_subarrays``/``n_columns``/``n_patterns``. Returns the map.
        """
        from repro_torch.reliability import (ReliabilityConfig,
                                             ReliabilityPlane, calibrate)
        cfg = self.config
        rmap = calibrate(
            cfg.mfr, banks=cfg.banks, n_subarrays=n_subarrays,
            n_columns=n_columns, n_patterns=n_patterns, configs=configs,
            seed=cfg.seed if seed is None else seed,
            process_variation=process_variation,
            device=self.engine.device)
        if save is not None:
            rmap.save(save)
        if attach:
            if inject and not self.engine.fuse:
                raise ValueError(
                    "reliability fault injection hooks the fused dispatch "
                    "path; this device runs eager (fuse=False)")
            rcfg = ReliabilityConfig(map=rmap, inject=inject, **policy)
            self.engine.reliability = ReliabilityPlane(
                rcfg, mfr=cfg.mfr, counters=self.engine.counters)
            # Planning/placement caches were computed without the map.
            self.engine._best_cfg_cache.clear()
            self.engine._batch_cache.clear()
            self.config = cfg.replace(reliability=rcfg)
        return rmap

    def autotune(self, profile=None, *, apply: bool = True,
                 cost_plane: bool = False, space=None, tuner=None,
                 online: bool = False, window_flushes: int = 16,
                 explore_every: int = 8, drift_threshold: float = 0.5,
                 save=None):
        """Tune this device's execution config from measured telemetry.

        ``profile`` is a :class:`~repro_torch.autotune.WorkloadProfile`
        (or a counter window to extract one from); by default it is taken
        from the device's accumulated counters — run the workload under
        :func:`profile` first (engine counters populate only while a
        tracer is attached). The :class:`~repro_torch.autotune.Tuner`
        searches the discrete config space over the backends available on
        this device's ``torch.device`` and returns the frozen
        :class:`~repro_torch.autotune.TunedPlan`; with ``apply=True``
        (default) the plan's *execution* knobs — fused backend, plane
        layout, auto-flush bounds, crossbar lookahead — are applied live
        to this device. Execution knobs change only where/when programs
        run: outputs and ``EngineStats`` are bit-identical to the static
        config. ``cost_plane=True`` additionally applies the
        REF-postponing recommendation, which changes the *modeled*
        refresh schedule and therefore EngineStats — an explicit opt-in.

        ``online=True`` installs an
        :class:`~repro_torch.autotune.OnlineAutotuner` on the engine:
        every ``window_flushes`` flushes (sync, or on the ``flush_async``
        worker) it profiles the counter delta and re-tunes when the drift
        detector fires (exploit) or every ``explore_every`` windows
        (explore). ``save=`` persists the plan (``.json``/``.npz``, see
        ``TunedPlan.save``). Returns the plan (``None`` with
        ``online=True`` before the first window closes).
        """
        from repro_torch.autotune import (OnlineAutotuner, Tuner,
                                          WorkloadProfile)
        if not self.engine.fuse:
            raise ValueError(
                "autotune targets the fused execution pipeline; this "
                "device runs eager (fuse=False)")
        if tuner is None:
            tuner = Tuner(space=space, drift_threshold=drift_threshold)
        if online:
            self.engine.autotuner = OnlineAutotuner(
                self, tuner=tuner, window_flushes=window_flushes,
                explore_every=explore_every,
                drift_threshold=drift_threshold)
            if profile is None:
                return None  # first window closes at flush granularity
        if profile is None:
            profile = WorkloadProfile.from_device(self)
        elif not isinstance(profile, WorkloadProfile):
            profile = WorkloadProfile.from_counters(
                profile, width=self.config.width,
                word_bits=self.config.resolved_layout().word_bits)
        plan = tuner.tune(profile, self.config)
        if apply:
            self._apply_plan(plan, cost_plane=cost_plane)
        if online and self.engine.autotuner is not None:
            self.engine.autotuner.plan = plan
        if save is not None:
            plan.save(save)
        return plan

    def _apply_plan(self, plan, *, cost_plane: bool = False,
                    flush: bool = True) -> None:
        """Reconfigure the live engine to a ``TunedPlan`` (the
        ``calibrate()`` idiom: mutate the engine, drop stale caches,
        replace ``self.config``). With ``flush=True`` pending graphs
        flush first so backend/layout flips never split a recorded
        program across lane formats; the online autotuner calls with
        ``flush=False`` from inside the flush path and the
        backend/layout switch is then deferred while graphs are
        pending. A layout flip leaves the leaf cache as it is: its key
        carries the layout, so a wire staged under one layout is never
        served to a pipeline of the other."""
        cfg = plan.apply(self.config, cost_plane=cost_plane)
        # A fuse flip cannot be applied to a live engine (it would
        # rebuild the whole execution pipeline mid-stream); the
        # recommendation stays on the returned plan for the caller to
        # construct a new device from.
        if cfg.fuse != self.config.fuse:
            cfg = cfg.replace(fuse=self.config.fuse)
        eng = self.engine
        if flush:
            eng.flush_all()
        with eng._lock:
            eng.flush_threshold = cfg.flush_threshold
            eng.flush_memory_bytes = cfg.flush_memory_bytes
            eng.cmd_buffer_lookahead = cfg.cmd_buffer_lookahead
            pending = bool(eng._inflight) or any(
                g is not None and getattr(g, "ops", None)
                for g in eng._slots.values())
            if pending:
                cfg = cfg.replace(fused_backend=self.config.fused_backend,
                                  layout=self.config.layout)
            else:
                eng.fused_backend = cfg.fused_backend
                eng.layout = cfg.resolved_layout()
            if cost_plane and cfg.ref_postponing != eng.ref_postponing \
                    and cfg.controller == "auto":
                from repro_torch.controller import MemoryController
                from repro_torch.core.cost_model import \
                    CostModel as _EngineCost
                eng.controller = MemoryController(
                    n_banks=cfg.banks, postponing=cfg.ref_postponing,
                    lookahead=cfg.cmd_buffer_lookahead)
                eng.ref_postponing = cfg.ref_postponing
                eng.cost = _EngineCost(row_bits=cfg.row_bits,
                                       controller=eng.controller)
            # Planning/batch caches were computed under the old config.
            eng._best_cfg_cache.clear()
            eng._batch_cache.clear()
        self.config = cfg

    def close(self) -> None:
        """Shut the async flush worker down (waits for in-flight
        dispatches); safe to call repeatedly, recreated lazily on the
        next ``flush_async``."""
        self.engine.close()

    def __enter__(self) -> "Device":
        _ACTIVE.append(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        _ACTIVE.remove(self)
        if exc_type is None:
            self.flush()
        self.close()

    # -- cost plane ----------------------------------------------------- #

    @property
    def stats(self):
        """Accumulated :class:`~repro_torch.core.engine.EngineStats`."""
        return self.engine.stats

    @property
    def counters(self):
        """The engine's telemetry :class:`~repro_torch.telemetry.
        CounterBank` (populated only while a tracer is attached, e.g.
        inside :func:`profile`)."""
        return self.engine.counters

    def reset_stats(self) -> None:
        self.engine.reset_stats()

    def reset_counters(self) -> None:
        self.engine.counters.clear()

    @property
    def reliability(self):
        """The engine's :class:`~repro_torch.reliability.ReliabilityPlane`
        (None unless configured or :meth:`calibrate`-attached)."""
        return self.engine.reliability

    @property
    def latency_ms(self) -> float:
        return self.engine.latency_ms

    @property
    def width(self) -> int:
        return self.engine.width

    @property
    def layout(self):
        return self.engine.layout

    @property
    def torch_device(self):
        """The ``torch.device`` fused flushes run on."""
        return self.engine.device

    def charge(self, kind: str, n_elems: int, width: int | None = None,
               n_planes: int | None = None) -> None:
        """Charge the cost plane for work the host performs on the PuM
        array's behalf (dataplane ops charge themselves)."""
        self.engine._charge(kind, n_elems, width=width, n_planes=n_planes)

    # -- op dispatch (PumArray operators land here) --------------------- #

    def _op(self, name: str, *operands):
        return getattr(self.engine, "_" + name)(*operands)

    def _broadcast_scalar(self, value, shape: tuple) -> np.ndarray:
        """One shared array per (scalar, shape), so the fused graph's
        id()-keyed leaf dedup hits instead of snapshotting a fresh leaf
        per op."""
        key = (int(value), shape)
        arr = self._scalars.get(key)
        if arr is None:
            if len(self._scalars) >= 64:
                self._scalars.clear()
            arr = np.broadcast_to(np.uint64(value), shape)
            self._scalars[key] = arr
        return arr

    def __repr__(self) -> str:
        c = self.config
        mode = "fused" if c.fuse else "eager"
        return (f"Device({c.mfr}:{c.width}w:{c.banks}b, "
                f"backend={c.backend!r}, {mode}, on {self.engine.device})")


class PumArray:
    """ndarray-like handle for a value on a PuM device.

    Operators record/execute through the owning device's engine and
    charge the cost plane; ``to_numpy()`` / ``np.asarray`` materialize
    (flushing the fused graph if pending).
    """

    __slots__ = ("_device", "_data")
    # Keep NumPy from consuming us element-wise: binary ops with ndarrays
    # come back through our reflected methods.
    __array_ufunc__ = None
    __array_priority__ = 1000

    def __init__(self, device: Device, data):
        self._device = device
        self._data = data

    @property
    def device(self) -> Device:
        return self._device

    @property
    def shape(self) -> tuple:
        return self._data.shape

    @property
    def size(self) -> int:
        return self._data.size

    @property
    def ndim(self) -> int:
        return self._data.ndim

    @property
    def dtype(self):
        return np.dtype(np.uint64)

    def __len__(self) -> int:
        if not self.shape:
            raise TypeError("len() of unsized PumArray")
        return self.shape[0]

    def __getitem__(self, idx) -> "PumArray":
        """Basic indexing along the lane axes; a pending handle
        materializes first (a slice is a host access pattern)."""
        data = self._data
        if isinstance(data, LazyArray):
            data = data.materialize()
        out = data[idx]
        if not isinstance(out, np.ndarray):  # 0-d from integer indexing
            out = np.asarray(out, np.uint64)
        return PumArray(self._device, out)

    def __repr__(self) -> str:
        pending = getattr(self._data, "_value", self._data) is None
        state = "pending" if pending else "materialized"
        return f"PumArray(shape={self.shape}, {state}, on {self._device})"

    def to_numpy(self) -> np.ndarray:
        """The value as a uint64 ndarray (flushes the fused graph if this
        handle is pending)."""
        return np.asarray(self._data, np.uint64)

    def __array__(self, dtype=None, copy=None):
        v = self.to_numpy()
        return v.astype(dtype) if dtype is not None else v

    def sum(self, *args, **kw):
        return self.to_numpy().sum(*args, **kw)

    def reshape(self, *shape, **kw) -> np.ndarray:
        return self.to_numpy().reshape(*shape, **kw)

    def astype(self, dtype, **kw) -> np.ndarray:
        return self.to_numpy().astype(dtype, **kw)

    # -- operator frontend ---------------------------------------------- #

    def _operand(self, other):
        """Same-device PumArrays pass their handle through (extending the
        fused graph); foreign-device arrays materialize; scalars broadcast
        to this array's shape so the op stays fusable."""
        if isinstance(other, PumArray):
            return other._data if other._device is self._device \
                else other.to_numpy()
        arr = np.asarray(other, np.uint64)
        if arr.ndim == 0 and self.shape:
            arr = self._device._broadcast_scalar(arr[()], self.shape)
        return arr

    def _binop(self, name: str, other, reflect: bool = False):
        a, b = self._data, self._operand(other)
        if reflect:
            a, b = b, a
        return PumArray(self._device, self._device._op(name, a, b))

    def __and__(self, other):
        return self._binop("and", other)

    def __rand__(self, other):
        return self._binop("and", other, reflect=True)

    def __or__(self, other):
        return self._binop("or", other)

    def __ror__(self, other):
        return self._binop("or", other, reflect=True)

    def __xor__(self, other):
        return self._binop("xor", other)

    def __rxor__(self, other):
        return self._binop("xor", other, reflect=True)

    def __add__(self, other):
        return self._binop("add", other)

    def __radd__(self, other):
        return self._binop("add", other, reflect=True)

    def __sub__(self, other):
        return self._binop("sub", other)

    def __rsub__(self, other):
        return self._binop("sub", other, reflect=True)

    def __mul__(self, other):
        return self._binop("mul", other)

    def __rmul__(self, other):
        return self._binop("mul", other, reflect=True)

    def __floordiv__(self, other):
        return self._binop("div", other)

    def __rfloordiv__(self, other):
        return self._binop("div", other, reflect=True)

    def __mod__(self, other):
        return self._binop("mod", other)

    def __rmod__(self, other):
        return self._binop("mod", other, reflect=True)

    def __divmod__(self, other):
        """(quotient, remainder) sharing ONE restoring-division pass."""
        q, r = self._device._op("divmod", self._data,
                                self._operand(other))
        return PumArray(self._device, q), PumArray(self._device, r)

    def __rdivmod__(self, other):
        q, r = self._device._op("divmod", self._operand(other),
                                self._data)
        return PumArray(self._device, q), PumArray(self._device, r)

    def __lt__(self, other):
        """Unsigned ``self < other`` per lane -> 0/1 PumArray."""
        return self._binop("less_than", other)

    def __gt__(self, other):
        return self._binop("less_than", other, reflect=True)

    def _not(self, bit: "PumArray") -> "PumArray":
        ones = self._device._broadcast_scalar(1, bit.shape)
        return PumArray(self._device,
                        self._device._op("xor", bit._data, ones))

    def __le__(self, other):
        """``self <= other`` == NOT(other < self): one compare + one XOR."""
        return self._not(self.__gt__(other))

    def __ge__(self, other):
        return self._not(self.__lt__(other))

    def popcount(self, width: int | None = None) -> "PumArray":
        """Per-element set-bit count over ``width`` planes."""
        return PumArray(self._device,
                        self._device._op("popcount", self._data, width))

    def reduce_bits(self, kind: str, width: int | None = None
                    ) -> "PumArray":
        """Per-element AND/OR/XOR reduction across the element's bits."""
        return PumArray(self._device,
                        self._device._op("reduce_bits", self._data, kind,
                                         width))

    def __eq__(self, other):
        return self.to_numpy() == np.asarray(other)

    def __ne__(self, other):
        return self.to_numpy() != np.asarray(other)

    __hash__ = None  # unhashable, like ndarray

    def __bool__(self):
        return bool(self.to_numpy())


def device(config: EngineConfig | None = None, **overrides) -> Device:
    """Build a :class:`Device` from an :class:`EngineConfig` (or keyword
    overrides of the defaults). The default ``device="cuda"`` raises on a
    host without CUDA."""
    return Device(config, **overrides)


def as_device(obj) -> Device:
    """Coerce to a :class:`Device`: passes Devices through and wraps an
    existing ``PulsarEngine`` (its configuration, reliability plane
    included, carried into the Device's config)."""
    if isinstance(obj, Device):
        return obj
    if isinstance(obj, PulsarEngine):
        cfg = EngineConfig(
            mfr=obj.mfr, width=obj.width, row_bits=obj.row_bits,
            banks=obj.banks, backend=obj.backend, use_pulsar=obj.use_pulsar,
            chained=obj.chained, controller=obj.controller, seed=obj.seed,
            fuse=obj.fuse, flush_threshold=obj.flush_threshold,
            flush_memory_bytes=obj.flush_memory_bytes,
            donate_leaves=obj.donate_leaves, success_db=obj.db,
            leaf_cache_bytes=obj.leaf_cache_bytes,
            layout=obj.layout, fused_backend=obj.fused_backend,
            ref_postponing=obj.ref_postponing,
            reliability=(None if obj.reliability is None
                         else obj.reliability.config),
            cmd_buffer_lookahead=obj.cmd_buffer_lookahead,
            device=str(obj.device))
        return Device(cfg, _engine=obj)
    raise TypeError(f"cannot interpret {type(obj).__name__} as a Device")


def default_device() -> Device:
    """The innermost active ``with device(...)`` scope, else a process-wide
    default ``Device(EngineConfig())`` built on first use."""
    global _DEFAULT
    if _ACTIVE:
        return _ACTIVE[-1]
    if _DEFAULT is None:
        _DEFAULT = Device(EngineConfig())
    return _DEFAULT


def asarray(x, device: Device | None = None) -> PumArray:
    """Wrap ``x`` as a :class:`PumArray` on ``device`` (default: the
    scoped/default device)."""
    return (device or default_device()).asarray(x)


@contextlib.contextmanager
def profile(device: Device | None = None, path: str | None = None):
    """Trace one device's fused flushes for the duration of the block.

    Attaches a fresh :class:`~repro_torch.telemetry.Tracer`, flushes any
    still-pending graph on exit so the trace is complete, then detaches.
    Yields the tracer; with ``path`` the Chrome trace-event JSON (plus the
    device's counters) is written there on exit. Profiling is
    observational only: results and ``Device.stats`` are identical with
    or without it."""
    from repro_torch.telemetry import Tracer

    dev = device if device is not None else default_device()
    tracer = Tracer()
    prev = dev.engine.tracer
    dev.engine.tracer = tracer
    try:
        yield tracer
    finally:
        try:
            dev.flush()  # complete the trace: pending graphs span-ify
        finally:
            dev.engine.tracer = prev
            if path is not None:
                tracer.export(path, counters=dev.engine.counters)
