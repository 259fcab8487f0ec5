"""PulsarEngine — the PuM compute engine behind ``repro_torch.pum``.

The port's copy of ``repro.core.engine``'s record and flush path. Two
coupled planes:

  * dataplane: bit-exact results. ``backend="fast"`` computes each op on
    packed NumPy uint64 words on the host (the eager mode, ``fuse=False``);
    ``backend="sim"`` runs the eager binary ops on the chip model's
    bit-serial ALU, its bank payload on the engine's device (per-op only);
    with ``fuse=True`` (the ``pum`` default) ops record into a lazy op
    graph and ``flush()`` runs the whole graph as ONE fused pipeline on
    the engine's ``torch.device`` — on a CUDA device the hand-written
    bit-transpose kernel packs the operands to vertical planes once, the
    generated fused-program kernel runs the program, and the transpose
    kernel unpacks the outputs once; on the CPU the same program runs in
    the word domain (``words-torch``).
  * cost plane: every op is priced at record time by the closed-form cost
    model (per-op best-throughput N_RG from the tabulated success rates,
    or from a calibrated reliability map), identically in eager and fused
    mode, so ``EngineStats`` match the reference's float for float.

``reliability=`` (a ``ReliabilityConfig`` or ``ReliabilityMap``) attaches a
:class:`~repro_torch.reliability.ReliabilityPlane`: the map drives the
per-op replication choice (and, under a controller, the bank order of the
priced batch), and with ``inject=True`` every fused flush runs the
fault-injection + replica-vote/retry loop on the flush's device (the MAJ-N
kernel on a CUDA device).

``controller="auto"`` (or a prebuilt
:class:`~repro_torch.controller.MemoryController`) prices every op through
the controller's scheduled bank batch — tFAW/tRRD-limited bank parallelism
and the steady-state refresh factor — instead of the closed-form bank
divide. The controller is a host simulation; it runs no kernel.

Concurrency: each client context (a thread, or a named :meth:`client`
scope) records into its own graph slot and charges its own stats shard;
``stats`` merges the shards in sorted-key order. :meth:`flush_async`
stages a flush on the caller and dispatches it on one worker thread, at
most two in flight, under the caller's CUDA device and stream.

Width semantics: fused arithmetic computes modulo 2**width; arithmetic
operands with bits at or above ``width`` are rejected at record time. The
plane-wise ops (``and``/``or``/``xor``/``popcount``) switch to a raw
packed-bitmap mode on out-of-width operands: each 64-bit word splits onto
the plane layout's lanes (two 32-bit lanes per word on the 32-bit layout)
and the lanes re-join at materialization.

Later slices bring the reference's other paths; asking for one raises
``NotImplementedError`` naming its slice: on ``pum.Device``, ``autotune``
(the autotune slice).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
import weakref
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.backends import get_backend, select_backend
from repro_torch.core.charact import SuccessRateDb, default_db
from repro_torch.core.cost_model import CostModel, OpCost
from repro_torch.core.profiles import PROFILES
from repro_torch.kernels import fused_program as _fused
from repro_torch.kernels.fused_program import (FusedOp, FusedProgram,
                                               get_pipeline,
                                               optimize_program,
                                               with_fault_injection)
from repro_torch.kernels.plane_layout import (PlaneLayout, get_layout,
                                              layout_for_width)
from repro_torch.telemetry import NULL_TRACER, CounterBank


def resolve_device(device) -> torch.device:
    """The engine's ``torch.device``; a CUDA device on a host without a
    usable card raises (the port never drops to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda is not "
            f"available on this host; pass device='cpu' to run the port "
            f"on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


@dataclasses.dataclass
class EngineStats:
    """Accumulated cost-plane charges for one engine session.

    Units: ``latency_ns`` and ``refresh_stall_ns`` in nanoseconds,
    ``energy_j`` in joules, ``n_sequences`` counts row-activation command
    sequences, ``lane_efficiency`` is the minimum success rate (0..1] over
    the ops used. Charges accrue at op-issue time in both eager and fused
    modes (``flush()`` never touches this object).
    """
    latency_ns: float = 0.0
    energy_j: float = 0.0
    n_sequences: int = 0
    lane_efficiency: float = 1.0  # min success rate over ops used
    refresh_stall_ns: float = 0.0  # controller-modeled REF interference

    def as_dict(self) -> dict:
        """Plain-JSON snapshot with explicit units in the key names."""
        return {
            "latency_ns": self.latency_ns,
            "energy_j": self.energy_j,
            "n_sequences": self.n_sequences,
            "lane_efficiency": self.lane_efficiency,
            "refresh_stall_ns": self.refresh_stall_ns,
        }

    def __repr__(self) -> str:
        return (f"EngineStats(latency={self.latency_ns:,.1f} ns, "
                f"energy={self.energy_j * 1e6:,.3f} uJ, "
                f"sequences={self.n_sequences:,}, "
                f"lane_efficiency={self.lane_efficiency:.4f}, "
                f"refresh_stall={self.refresh_stall_ns:,.1f} ns)")

    def charge(self, cost: OpCost, n_vec_rows: int, banks: int,
               success: float, batch=None) -> None:
        if batch is None:
            # Closed-form divide: ideal bank-level parallelism.
            eff_rows = -(-n_vec_rows // banks)
            self.latency_ns += cost.latency_ns * eff_rows
        else:
            # Controller-scheduled pricing: the measured bank-parallel
            # speedup (tFAW/tRRD/bus-limited, <= banks) and the steady-state
            # refresh slowdown replace the ideal divide.
            speedup = max(1.0, batch.parallel_speedup)
            base = max(cost.latency_ns * n_vec_rows / speedup,
                       cost.latency_ns * (-(-n_vec_rows // banks)))
            total = base * batch.refresh_factor
            self.latency_ns += total
            self.refresh_stall_ns += total - base
        self.energy_j += cost.energy_j * n_vec_rows
        self.n_sequences += cost.n_sequences * n_vec_rows
        self.lane_efficiency = min(self.lane_efficiency, success)


class FlushHandle:
    """Future-like handle for one :meth:`PulsarEngine.flush_async`.

    ``result()`` blocks until the dispatched graph(s) materialize and
    re-raises the flush error on failure — a failed async flush parks its
    graph for retry exactly like a failed synchronous ``flush()``, so a
    later ``flush()``/``materialize()`` recovers the pending handles."""

    __slots__ = ("_future",)

    def __init__(self, future=None):
        self._future = future  # None => the flush had nothing to dispatch

    def done(self) -> bool:
        return self._future is None or self._future.done()

    def result(self, timeout: float | None = None) -> None:
        """Wait for the dispatch; re-raises the flush failure, if any."""
        if self._future is not None:
            self._future.result(timeout)

    def exception(self, timeout: float | None = None):
        if self._future is None:
            return None
        return self._future.exception(timeout)

    def __repr__(self) -> str:
        state = "done" if self.done() else "in-flight"
        return f"FlushHandle({state})"


class LazyArray:
    """Handle for a value pending in the engine's fused op graph.

    Behaves like a read-only array: ``np.asarray`` (or ``materialize()``)
    triggers the flush of its graph on first access. Feeding it back into
    engine ops extends the graph instead of materializing.
    """

    __slots__ = ("_engine", "_graph", "_op_idx", "shape", "__weakref__",
                 "_value")

    def __init__(self, engine: "PulsarEngine", graph: "_OpGraph",
                 op_idx: int, shape: tuple):
        self._engine = engine
        self._graph = graph
        self._op_idx = op_idx
        self.shape = shape
        self._value: np.ndarray | None = None

    @property
    def size(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def dtype(self):
        return np.dtype(np.uint64)

    def materialize(self) -> np.ndarray:
        if self._value is None:
            g, eng = self._graph, self._engine
            if g is not None and eng is not None:
                # Route to the owning graph: it may belong to another
                # client context, sit on the retry list, or be in flight
                # on the async flush worker.
                eng._materialize_graph(g)
            elif eng is not None:
                eng.flush()
        if self._value is None:
            raise RuntimeError(
                "LazyArray failed to materialize: the engine flush that "
                "should have produced it did not complete")
        return self._value

    def __array__(self, dtype=None, copy=None):
        v = self.materialize()
        return v.astype(dtype) if dtype is not None else v

    def sum(self, *args, **kw):
        return self.materialize().sum(*args, **kw)

    def reshape(self, *shape, **kw) -> np.ndarray:
        return self.materialize().reshape(*shape, **kw)

    def astype(self, dtype, **kw) -> np.ndarray:
        return self.materialize().astype(dtype, **kw)

    def __eq__(self, other):
        return self.materialize() == np.asarray(other)

    def __ne__(self, other):
        return self.materialize() != np.asarray(other)

    __hash__ = None  # unhashable, like ndarray

    def __bool__(self):
        return bool(self.materialize())

    def __repr__(self) -> str:
        state = "pending" if self._value is None else "materialized"
        return f"LazyArray(shape={self.shape}, {state})"


def _DEAD_REF():  # weakref stand-in for ops that must never be outputs
    return None


def _stage_wire(flat, pad: int, layout: PlaneLayout,
                copy: bool = False) -> np.ndarray:
    """Flat lane array -> padded int32 wire array with AT MOST one host
    copy: the pad tail and the lane-dtype conversion fuse into a single
    allocation, and an in-dtype unpadded input stages as a pure view
    unless ``copy`` forces private memory (required when ``flat`` still
    aliases a caller buffer)."""
    if pad:
        out = np.zeros(flat.size + pad, layout.np_dtype)
        out[:flat.size] = flat
        return layout.to_wire(out)
    if flat.dtype != layout.np_dtype:
        return layout.to_wire(flat.astype(layout.np_dtype))
    if copy:
        flat = flat.copy()
    return layout.to_wire(flat)


class _LeafCacheEntry:
    """One cached leaf upload: the private padded host wire plus (lazily)
    its tensor on the engine's device. ``fp`` is the 257-sample content
    fingerprint taken when the source buffer was registered."""

    __slots__ = ("key", "fp", "wire", "dev", "nbytes")

    def __init__(self, key, fp, wire):
        self.key = key
        self.fp = fp
        self.wire = wire        # private padded int32 host wire
        self.dev = None         # int32 tensor on the device (lazy)
        self.nbytes = wire.nbytes


class _LeafCache:
    """Fingerprint-keyed cache of staged leaf uploads (the device-resident
    leaf cache). Keyed on the *caller buffer* — (data pointer, byte size,
    layout, raw mode) — and guarded by the sampled content fingerprint,
    so repeated flushes over the same operands stage zero bytes and
    upload nothing: the entry's host wire is private and its device
    tensor (a CUDA tensor on a CUDA engine) is uploaded once and kept
    across flushes. LRU-bounded by ``capacity`` bytes of host wire.

    Donation policy: a donating flush never passes a cached tensor to the
    pipeline — it uploads the private host wire afresh and drops the
    entry's device residency."""

    def __init__(self, capacity: int, device: torch.device):
        self.capacity = capacity
        self.device = device
        self._lock = threading.Lock()
        self._entries: collections.OrderedDict = collections.OrderedDict()
        self._bytes = 0

    def lookup(self, key, fp) -> "_LeafCacheEntry | None":
        with self._lock:
            e = self._entries.get(key)
            if e is not None and np.array_equal(e.fp, fp):
                self._entries.move_to_end(key)
                return e
            return None

    def insert(self, key, fp, wire) -> tuple["_LeafCacheEntry | None", int]:
        """Cache ``wire`` (a private buffer) under ``key``; returns
        ``(entry, n_evicted)``. Oversized singletons are not cached."""
        if wire.nbytes > self.capacity:
            return None, 0
        entry = _LeafCacheEntry(key, fp, wire)
        evicted = 0
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes
            self._entries[key] = entry
            self._bytes += entry.nbytes
            while self._bytes > self.capacity and len(self._entries) > 1:
                _, dead = self._entries.popitem(last=False)
                self._bytes -= dead.nbytes
                evicted += 1
        return entry, evicted

    def device_buffer(self, entry: "_LeafCacheEntry") -> torch.Tensor:
        """The entry's tensor on the device (uploads once, lazily).

        The tensor is shared by every client context and capture, which
        may launch on other CUDA streams than the one it was allocated
        on: each use records the calling thread's current stream, so the
        allocator never reuses its memory under a kernel still reading
        it."""
        dev = entry.dev
        if dev is None:
            dev = _upload(entry.wire, self.device)
            with self._lock:
                if entry.dev is None:
                    entry.dev = dev
                else:       # another flush won the upload race
                    dev = entry.dev
        if dev.is_cuda:
            dev.record_stream(torch.cuda.current_stream(dev.device))
        return dev

    def drop_device(self, entry: "_LeafCacheEntry") -> None:
        with self._lock:
            entry.dev = None


def _upload(wire: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host int32 wire -> int32 tensor on ``device`` (zero-copy on the
    CPU: the wire is private and never written)."""
    t = torch.from_numpy(wire)
    return t if device.type == "cpu" else t.to(device)


class _Leaf:
    """One registered operand of an op graph: ``entry`` (a leaf-cache hit)
    or ``wire`` (the record-time snapshot, already in padded wire form).
    A snapshot that seeded a new cache entry keeps it as ``seed``, so the
    flush uploads through the entry and the next flush over the same
    buffer finds the tensor already on the device."""

    __slots__ = ("wire", "entry", "seed", "nbytes")

    def __init__(self, wire=None, entry=None, nbytes=0, seed=None):
        self.wire = wire
        self.entry = entry
        self.seed = seed
        self.nbytes = nbytes


_FP_IDX_CACHE: dict[int, np.ndarray] = {}


def _fp_indices(n: int) -> np.ndarray:
    idx = _FP_IDX_CACHE.get(n)
    if idx is None:
        if len(_FP_IDX_CACHE) >= 1024:  # unbounded lane-count churn guard
            _FP_IDX_CACHE.clear()
        idx = np.linspace(0, n - 1, min(n, 257)).astype(np.int64)
        idx.setflags(write=False)
        _FP_IDX_CACHE[n] = idx
    return idx


class _OpGraph:
    """Recording buffer for one fused program: leaf operand snapshots plus
    the op list, with weakrefs to the handed-out LazyArrays (ops whose
    handle died unreferenced are dead code — never materialized).

    ``raw=True`` marks a packed-bitmap graph: plane-wise ops on raw uint64
    words, each reinterpreted as ``layout.raw_lanes_per_word`` lanes
    (``n`` counts lanes, width is the layout's word size). A graph is
    entirely raw or entirely value-mode; the engine flushes at mode
    boundaries."""

    def __init__(self, n: int, width: int, layout: PlaneLayout,
                 raw: bool = False, cache: "_LeafCache | None" = None):
        self.n = n                      # dataplane lane count (all values)
        self.width = width
        self.layout = layout
        self.raw = raw
        self.cache = cache              # engine's leaf cache (may be None)
        self.leaves: list[_Leaf] = []
        self._leaf_ids: dict[int, int] = {}
        self._pins: list[np.ndarray] = []  # keep id() keys alive
        self._fps: list[np.ndarray] = []   # content fingerprints
        self._fp_idx = _fp_indices(n)
        self._pad = (-n) % 32  # every pipeline tiles lanes in groups of 32
        self.elided_bytes = 0  # snapshot copies skipped (cache hit / view)
        self.cache_evictions = 0
        self.ops: list[tuple[str, tuple, int]] = []  # (opcode, args, param)
        self.results: list = []         # weakref per op
        self.t_start: int | None = None  # first-op time (tracer attached)
        # Flush lifecycle (guarded by the engine lock): "recording" in a
        # client context's slot, "queued" on the retry list after a failed
        # flush, "flushing" (``done`` is then an Event concurrent
        # materializers wait on), "done".
        self.state: str = "recording"
        self.done: threading.Event | None = None

    def leaf_id(self, arr: np.ndarray) -> tuple[str, int]:
        """Register an operand under the copy-on-write snapshot contract:
        the graph never aliases caller buffers, so mutations between record
        and flush cannot diverge from eager results. Re-feeding the same
        array object dedups to one pipeline input, guarded by a sampled
        content fingerprint. The record-time copy is skipped on a
        leaf-cache hit and when ``ravel()`` already privatized the memory.
        """
        key = id(arr)
        rav = arr.ravel()
        flat = rav
        if self.raw:  # reinterpret uint64 words as layout lanes
            flat = self.layout.raw_lanes(rav)
        idx = self._leaf_ids.get(key)
        if idx is not None and np.array_equal(flat[self._fp_idx],
                                              self._fps[idx]):
            return ("leaf", idx)
        if not self.raw and self.width < 64 and flat.size \
                and int(flat.max()) >> self.width:
            raise ValueError(
                f"fused dataplane computes modulo 2**{self.width}; an "
                f"operand has bits at or above bit {self.width} — mask "
                f"inputs to the engine width or use fuse=False")
        i = len(self.leaves)
        self._leaf_ids[key] = i  # latest content owns the dedup slot
        fp = flat[self._fp_idx]  # fancy indexing: always a private copy
        nbytes = flat.size * self.layout.nbytes_per_word
        # ``ravel()`` returns a view (base set) iff the flat memory still
        # belongs to the caller; a fresh copy (base None) is private.
        shared = rav.base is not None or rav is arr
        ckey = entry = None
        if shared and self.cache is not None and flat.size:
            ckey = (flat.__array_interface__["data"][0], flat.nbytes,
                    self.layout.name, self.raw)
            entry = self.cache.lookup(ckey, fp)
        if entry is not None:
            self.elided_bytes += nbytes          # record-time cache hit
            self.leaves.append(_Leaf(entry=entry, nbytes=nbytes))
        else:
            wire = _stage_wire(flat, self._pad, self.layout, copy=shared)
            if wire.base is not None and not shared:
                self.elided_bytes += nbytes      # staged as a pure view
            if ckey is not None:                 # seed for the next flush
                entry, ev = self.cache.insert(ckey, fp, wire)
                self.cache_evictions += ev
            self.leaves.append(_Leaf(wire=wire, nbytes=nbytes, seed=entry))
        self._fps.append(fp)
        self._pins.append(arr)
        return ("leaf", i)

    def stage_leaf(self, li: int) -> np.ndarray:
        """The padded int32 host wire for leaf ``li`` (zero-copy: the
        record-time snapshot or the cached upload's host wire)."""
        leaf = self.leaves[li]
        return leaf.wire if leaf.entry is None else leaf.entry.wire

    def add_op(self, opcode: str, args: tuple, param: int,
               out: "LazyArray", internal: bool = False) -> int:
        self.ops.append((opcode, args, param))
        # Internal ops (tuple values feeding selectors) record a dead ref:
        # they can never be materialized as a program output.
        self.results.append(_DEAD_REF if internal else weakref.ref(out))
        return len(self.ops) - 1


def _cuda_scope(where):
    """Context that makes ``where`` = (device, stream) current on the
    calling thread (a null context for ``None``: a CPU engine)."""
    stack = contextlib.ExitStack()
    if where is not None:
        stack.enter_context(torch.cuda.device(where[0]))
        stack.enter_context(torch.cuda.stream(where[1]))
    return stack


class PulsarEngine:
    """Bulk bitwise/bit-serial integer SIMD on (simulated) PuM DRAM.

    Dataplane values are unsigned integers carried in uint64 ndarrays;
    arithmetic ops compute modulo ``2**width``. The cost plane prices every
    op via the paper-calibrated ``CostModel`` independent of the
    dataplane. With ``fuse=True`` ops return :class:`LazyArray` handles
    and run as one fused pipeline per :meth:`flush` on ``device`` —
    bit-exact and stats-identical to eager, including division by zero.

    ``flush_threshold`` (recorded ops) and ``flush_memory_bytes``
    (estimated graph footprint) auto-flush oversized graphs; ``None``
    disables either bound. ``donate_leaves=True``: uploaded leaf buffers
    are neither cached nor kept after dispatch (results identical).
    """

    def __init__(self, mfr: str = "M", width: int = 32,
                 row_bits: int = 65536, banks: int = 16,
                 backend: str = "fast",
                 success_db: SuccessRateDb | None = None,
                 use_pulsar: bool = True, chained: bool = False,
                 controller=None, seed: int = 0, fuse: bool = False,
                 flush_threshold: int | None = 1024,
                 flush_memory_bytes: int | None = 1 << 30,
                 donate_leaves: bool = False, layout=None,
                 fused_backend: str | None = None,
                 ref_postponing: int = 1, reliability=None,
                 cmd_buffer_lookahead: int = 8,
                 leaf_cache_bytes: int | None = 1 << 26,
                 device="cuda"):
        self.device = resolve_device(device)
        self.profile = PROFILES[mfr]
        self.mfr = mfr
        self.width = width
        self.row_bits = row_bits
        self.banks = banks
        self.backend = backend
        self.seed = seed
        self.use_pulsar = use_pulsar  # False => FracDRAM baseline costs
        self.chained = chained and use_pulsar  # chained-staging (§Perf P4)
        self.layout = (layout_for_width(width) if layout is None
                       else get_layout(layout))
        if width > self.layout.word_bits:
            raise ValueError(
                f"width {width} does not fit the {self.layout.word_bits}"
                f"-bit plane layout {self.layout.name!r}")
        # controller="auto" builds a MemoryController over `banks` banks;
        # None keeps the closed-form bank divide. `ref_postponing` batches
        # up to N REF commands into one rank lockout (JEDEC allows 8).
        if not 1 <= ref_postponing <= 8:
            raise ValueError(
                f"ref_postponing must be in [1, 8] (JEDEC allows "
                f"postponing up to 8 REFs), got {ref_postponing}")
        if ref_postponing != 1 and controller != "auto":
            raise ValueError(
                "ref_postponing requires controller='auto' (with "
                "controller=None refresh is not modeled; a prebuilt "
                "MemoryController sets postponing= itself)")
        if cmd_buffer_lookahead < 1:
            raise ValueError(f"cmd_buffer_lookahead must be >= 1, got "
                             f"{cmd_buffer_lookahead}")
        if controller == "auto":
            from repro_torch.controller import MemoryController
            controller = MemoryController(n_banks=banks,
                                          postponing=ref_postponing,
                                          lookahead=cmd_buffer_lookahead)
        self.controller = controller
        self.ref_postponing = ref_postponing
        # Crossbar command-buffer depth for concurrent-stream scheduling;
        # execution-only (never priced by the single-stream cost plane).
        self.cmd_buffer_lookahead = cmd_buffer_lookahead
        self.cost = CostModel(row_bits=row_bits, controller=controller)
        self.db = success_db or default_db()
        # Concurrency state: one recording slot + one EngineStats shard
        # per client context (a thread, or a named ``client()`` scope).
        # The RLock guards all record-side mutation (slots, shards, cost
        # caches, the retry list); pipeline dispatch runs outside it.
        self._lock = threading.RLock()
        self._local = threading.local()
        self._slots: dict[tuple, _OpGraph] = {}
        self._stats_shards: dict[tuple, EngineStats] = {}
        self._retry: list[_OpGraph] = []       # failed flushes, FIFO
        self._inflight: dict[int, object] = {}  # id(graph) -> Future
        self._executor: ThreadPoolExecutor | None = None
        # Double-buffered async flush: at most 2 staged dispatches in
        # flight — the caller stages flush k+1 while the worker runs k.
        self._async_slots = threading.BoundedSemaphore(2)
        self._best_cfg_cache: dict = {}
        self._batch_cache: dict[tuple, object] = {}
        spec = get_backend(backend)
        if "eager" not in spec.capabilities:
            raise ValueError(
                f"backend {backend!r} has no eager dataplane "
                f"(capabilities: {sorted(spec.capabilities)})")
        if width > spec.max_width:
            raise ValueError(
                f"backend {backend!r} supports width <= {spec.max_width}, "
                f"got {width}")
        if not spec.available(self.device):
            raise ValueError(f"backend {backend!r} is registered but not "
                             f"available on {self.device}")
        # The builder returns None for the packed-NumPy word dataplane or an
        # ALU-protocol object (the sim backend's BitSerialAlu) to route the
        # eager binary ops through.
        self._alu = spec.builder(self)
        if fuse and self._alu is not None:
            raise ValueError(
                f"fuse=True requires an eager word-dataplane backend "
                f"(builder returns None, e.g. 'fast'); backend "
                f"{backend!r} routes ops through an ALU and stays "
                f"per-op")
        if fused_backend is not None:
            fspec = get_backend(fused_backend)
            if "fused" not in fspec.capabilities:
                raise ValueError(
                    f"fused_backend {fused_backend!r} has no fused "
                    f"evaluator (capabilities: "
                    f"{sorted(fspec.capabilities)})")
            if width > fspec.max_width \
                    or self.layout.word_bits not in fspec.layouts:
                raise ValueError(
                    f"fused_backend {fused_backend!r} covers width <= "
                    f"{fspec.max_width} on layouts "
                    f"{sorted(fspec.layouts)}; engine is width {width} "
                    f"on the {self.layout.word_bits}-bit layout")
        elif fuse:
            try:
                select_backend(require="fused", device=self.device,
                               width=width, layout=self.layout)
            except LookupError as e:
                raise ValueError(
                    f"no registered fused evaluator covers width {width} "
                    f"on the {self.layout.word_bits}-bit plane layout "
                    f"({e}); use fuse=False or register_backend() one"
                ) from None
        if flush_threshold is not None and flush_threshold < 1:
            raise ValueError("flush_threshold must be >= 1 or None")
        if leaf_cache_bytes is not None and leaf_cache_bytes < 0:
            raise ValueError(
                f"leaf_cache_bytes must be >= 0 or None (0/None disables "
                f"the leaf cache), got {leaf_cache_bytes}")
        self.fuse = fuse
        self.fused_backend = fused_backend
        self.flush_threshold = flush_threshold
        self.flush_memory_bytes = flush_memory_bytes
        self.donate_leaves = donate_leaves
        self.leaf_cache_bytes = leaf_cache_bytes or 0
        self._leaf_cache = (_LeafCache(leaf_cache_bytes, self.device)
                            if leaf_cache_bytes else None)
        # Telemetry: counters always exist (written only while a tracer is
        # attached); the disabled path is one `is None` check per flush.
        self.counters = CounterBank()
        self.tracer = None
        # Autotuner hook: None (default) costs one `is None` check per
        # flush; Device.autotune(online=True) installs a
        # repro_torch.autotune.OnlineAutotuner whose on_flush() closes the
        # measure->decide->apply loop at flush granularity.
        self.autotuner = None
        # Reliability plane: calibrated-map planning plus the flush-time
        # injection + vote/retry loop. None (default) keeps every path
        # as it is — one `is None` check per op and per flush.
        self.reliability = None
        if reliability is not None:
            from repro_torch.reliability import ReliabilityPlane
            self.reliability = ReliabilityPlane(
                reliability, mfr=mfr, counters=self.counters)
            if self.reliability.inject and not fuse:
                raise ValueError(
                    "reliability fault injection hooks the fused dispatch "
                    "path; it requires fuse=True (eager ops never run the "
                    "vote/retry loop)")
        # The normalized program of the most recent fused flush (what the
        # pipeline ran; for inspection).
        self.last_program: FusedProgram | None = None

    # ------------------------------------------------------------------ #
    # Client contexts (per-thread / named recording slots + stats shards)
    # ------------------------------------------------------------------ #

    def _ctx_key(self) -> tuple:
        name = getattr(self._local, "client", None)
        if name is not None:
            return ("client", name)
        return ("thread", threading.get_ident())

    @contextlib.contextmanager
    def client(self, name: str):
        """Scope ops to a named client context: recorded ops go to the
        context's own graph slot and cost charges to its own stats shard,
        so N logical clients share one engine (from any threads) without
        interleaving their programs. Without a ``client()`` scope the
        calling thread is its own implicit context."""
        prev = getattr(self._local, "client", None)
        self._local.client = str(name)
        try:
            yield self
        finally:
            self._local.client = prev

    @property
    def _graph(self) -> "_OpGraph | None":
        """The current client context's recording graph (or None)."""
        return self._slots.get(self._ctx_key())

    @_graph.setter
    def _graph(self, g: "_OpGraph | None") -> None:
        key = self._ctx_key()
        if g is None:
            self._slots.pop(key, None)
        else:
            self._slots[key] = g

    def _stats_shard(self) -> EngineStats:
        s = self._stats_shards.get(self._ctx_key())
        if s is None:
            s = self._stats_shards[self._ctx_key()] = EngineStats()
        return s

    @property
    def stats(self) -> EngineStats:
        """Merged cost-plane charges across every client context. Shards
        merge in sorted-key order, so the totals do not depend on which
        thread interleaving produced the charges (float addition is
        order-sensitive); one context is bit-identical to one
        accumulator."""
        with self._lock:
            out = EngineStats()
            for key in sorted(self._stats_shards, key=str):
                s = self._stats_shards[key]
                out.latency_ns += s.latency_ns
                out.energy_j += s.energy_j
                out.n_sequences += s.n_sequences
                out.lane_efficiency = min(out.lane_efficiency,
                                          s.lane_efficiency)
                out.refresh_stall_ns += s.refresh_stall_ns
            return out

    # ------------------------------------------------------------------ #
    # Cost plumbing
    # ------------------------------------------------------------------ #

    def _kind_cost(self, kind: str, m: int, n_rg: int, w: int,
                   n_planes: int | None, n_rg3: int | None = None) -> OpCost:
        fs = self.profile.frac_supported
        ps = "pow2" if self.use_pulsar else "max"
        kw = dict(frac_supported=fs, plan_style=ps)
        ckw = dict(kw, chained=self.chained)
        c = self.cost
        if kind in ("and2", "or2"):
            return c.logic2(min(3, m), n_rg, **kw)
        if kind == "xor2":
            return c.xor2(min(3, m), n_rg, **kw)
        if kind == "add" or kind == "sub":
            return c.add(w, m, n_rg, n_rg3, **ckw)
        if kind == "mul":
            return c.mul(w, m, n_rg, n_rg3, **ckw)
        if kind == "div":
            return c.div(w, m, n_rg, n_rg3, **ckw)
        if kind in ("reduce_and", "reduce_or"):
            return c.reduce_tree(n_planes or w, m, n_rg, **ckw)
        if kind == "reduce_xor":
            return c.xor_reduce(n_planes or w, m, n_rg, **ckw)
        if kind == "popcount":
            out_w = max(1, (n_planes or w).bit_length())
            return (n_planes or w) * out_w * c.full_adder(m, n_rg, n_rg3,
                                                          **ckw)
        if kind == "compare":
            return c.add(w + 1, m, n_rg, n_rg3, **ckw)
        if kind in ("load", "store"):
            return (c.write_row() if kind == "load" else c.read_row()) * (2 * w)
        raise KeyError(kind)

    _ARITH = ("add", "sub", "mul", "div", "popcount", "compare")

    def _cfg_for(self, kind: str, w: int, n_planes: int | None
                 ) -> tuple[int, int, float, OpCost]:
        """Best (maj_fan_in, n_rg[, n_rg3]) for this op kind: minimizes
        latency / success_rate — the paper's per-op configuration search.
        Arithmetic kinds search MAJ3/MAJ5 sub-op configs independently."""
        if not self.use_pulsar:
            # FracDRAM baseline: MAJ3 on 4-row activation only.
            sr = self.db.mean(self.mfr, 3, 4)
            return 3, 4, sr, self._kind_cost(kind, 3, 4, w, n_planes, 4)
        key = (kind, w, n_planes)
        if key not in self._best_cfg_cache:
            prof = self.profile
            cap = prof.max_simul_rows
            pows = [n for n in (4, 8, 16, 32) if n <= cap]
            rel = self.reliability

            def sr_of(m, n):
                if n < m:
                    return 0.0
                if rel is not None:
                    # Variation-aware planning: the calibrated map's
                    # (steering-weighted) rate for profiled configs; the
                    # global table covers the rest.
                    s = rel.plan_success(m, n)
                    if s is not None:
                        return s
                return self.db.mean(self.mfr, m, n, plan_style="pow2")

            candidates: list[tuple[int, int, int | None]] = []
            if kind in self._ARITH:
                for n3 in pows:                       # MAJ3-only FA
                    candidates.append((3, n3, None))
                if prof.max_maj_fan_in >= 5:
                    for n5 in pows:
                        for n3 in pows:
                            if n5 >= 5:
                                candidates.append((5, n5, n3))
            else:
                m = 3
                while m <= min(prof.max_maj_fan_in, cap):
                    for n in pows:
                        if n >= m:
                            candidates.append((m, n, None))
                    m += 2
            best = None
            best_ok = None  # reliability: best config MEETING the target
            target = (rel.config.target_success if rel is not None else None)
            for m, n, n3 in candidates:
                sr = sr_of(m, n)
                if n3 is not None:
                    sr = min(sr, sr_of(3, n3))
                if sr <= 1e-3:
                    continue
                cost = self._kind_cost(kind, m, n, w, n_planes, n3)
                eff = cost.latency_ns / sr
                if best is None or eff < best[0]:
                    best = (eff, m, n, sr, cost)
                if target is not None and sr >= target \
                        and (best_ok is None or eff < best_ok[0]):
                    best_ok = (eff, m, n, sr, cost)
            if best is None:
                raise ValueError(f"no viable config for {kind} on Mfr "
                                 f"{self.mfr}")
            # Per-op replication choice (Fig 11): prefer the fastest config
            # whose calibrated success meets the reliability target; only
            # when none does fall back to raw throughput (the vote/retry
            # loop then carries the correction burden).
            self._best_cfg_cache[key] = (best_ok or best)[1:]
        return self._best_cfg_cache[key]

    def _n_vec_rows(self, n_elems: int) -> int:
        return -(-n_elems // self.row_bits)

    def _batch_for(self, kind: str, m: int, n_rg: int):
        """Controller-measured bank-batch cost for this op's dominant
        primitive (the MAJ unit for compute kinds, the full-row transfer
        program for load/store), cached per configuration."""
        if kind in ("load", "store"):
            key = ("io", kind)
        else:
            key = ("maj", m, n_rg, self.chained)
        if key not in self._batch_cache:
            from repro_torch.core import commands as cmds
            t = self.cost.t
            if kind == "load":
                unit = [cmds.prog_write_row(0, 0, self.cost._wr_bursts, t)]
            elif kind == "store":
                unit = [cmds.prog_read_row(0, 0, self.cost._wr_bursts, t)]
            else:
                unit = self.cost.maj_unit_programs(
                    m, n_rg, frac_supported=self.profile.frac_supported,
                    plan_style="pow2" if self.use_pulsar else "max",
                    # Chained staging keeps one input resident per MAJ, so
                    # measure bank contention on the thinner command stream.
                    resident_inputs=1 if self.chained else 0)
            # The calibrated map's bank ranking: batches prefer strong
            # banks.
            order = (tuple(self.reliability.bank_order(self.banks))
                     if self.reliability is not None else None)
            self._batch_cache[key] = self.controller.batch_cost(
                unit, self.banks, bank_order=order)
        return self._batch_cache[key]

    def _charge(self, kind: str, n_elems: int, width: int | None = None,
                n_planes: int | None = None) -> None:
        with self._lock:
            log = getattr(self._local, "charge_log", None)
            if log is not None:
                # Program capture records the charge recipe so replays
                # price identically to the uncaptured path.
                log.append((kind, n_elems, width, n_planes))
            w = width or self.width
            m, n, sr, cost = self._cfg_for(kind, w, n_planes)
            if self.reliability is not None:
                # The flush-time vote loop injects at the worst config used.
                self.reliability.note_op(m, n, sr)
            batch = (self._batch_for(kind, m, n)
                     if self.controller is not None else None)
            self._stats_shard().charge(cost, self._n_vec_rows(n_elems),
                                       self.banks, sr, batch)

    def _replay_charges(self, recipe) -> None:
        """Re-apply a captured charge recipe (one replayed program)."""
        for kind, n_elems, width, n_planes in recipe:
            self._charge(kind, n_elems, width, n_planes)

    def op_effective_ns(self, kind: str, width: int | None = None,
                        n_planes: int | None = None
                        ) -> tuple[float, float, int, int]:
        """Amortized per-vector-row latency of one op at this engine's bank
        count: ``(latency_ns, success_rate, maj_fan_in, n_rg)``. With a
        controller the latency is priced through the scheduled bank batch
        (tFAW/tRRD-limited speedup + refresh factor); without one it is the
        closed-form single-bank latency divided by ``banks``."""
        w = width or self.width
        m, n, sr, cost = self._cfg_for(kind, w, n_planes)
        if self.controller is None:
            return cost.latency_ns / self.banks, sr, m, n
        b = self._batch_for(kind, m, n)
        eff = (cost.latency_ns / max(1.0, b.parallel_speedup)
               * b.refresh_factor)
        return eff, sr, m, n

    # ------------------------------------------------------------------ #
    # Dataplane ops (eager: NumPy on the host; fuse=True: record into the
    # lazy op graph, execute at flush())
    # ------------------------------------------------------------------ #

    def _mask(self, w: int) -> np.uint64:
        return np.uint64((1 << w) - 1)

    def _coerce(self, x):
        """Engine-op operand: LazyArrays pass through while pending (so the
        graph extends); everything else becomes a uint64 ndarray."""
        if isinstance(x, LazyArray):
            return x if x._value is None else x._value
        return np.asarray(x, np.uint64)

    def _force(self, x) -> np.ndarray:
        return x.materialize() if isinstance(x, LazyArray) else x

    def _can_fuse(self, *operands) -> bool:
        if not self.fuse:
            return False
        shape = operands[0].shape
        return all(x.shape == shape for x in operands[1:])

    def _is_raw_operand(self, x) -> bool:
        """Does this operand carry bits at or above the engine width?"""
        if isinstance(x, LazyArray):
            if x._value is None:
                return x._graph is not None and x._graph.raw
            x = x._value
        return bool(self.width < 64 and x.size
                    and int(x.max()) >> self.width)

    def _use_raw(self, operands: tuple) -> bool:
        """Plane-wise ops route through the raw packed-bitmap graph when
        any operand is out of width or when a raw graph of the same lane
        count is already open."""
        g = self._graph
        if g is not None and g.raw \
                and g.n == self.layout.raw_lanes_per_word \
                * operands[0].size:
            return True
        return any(self._is_raw_operand(x) for x in operands)

    def _record(self, opcode: str, operands: tuple, param: int = 0,
                raw: bool = False, defer_flush: bool = False,
                internal: bool = False) -> LazyArray:
        """Append one op to the lazy graph (starting/flushing as needed)
        and hand back its LazyArray. ``defer_flush`` skips the auto-flush
        check so a multi-op lowering (divmod -> selectors) records
        atomically; ``internal=True`` marks an op that must never be a
        program output."""
        shape = operands[0].shape
        lanes_per_word = self.layout.raw_lanes_per_word if raw else 1
        n = operands[0].size * lanes_per_word  # dataplane lanes
        g = self._graph
        if g is not None and (g.n != n or g.raw != raw):
            if self.tracer is not None:
                self.counters.inc("engine.autoflush.mode_boundary")
            self.flush()  # one program = one lane count and one mode

        # Cross-context materialization (a pending lazy of ANOTHER graph
        # entering as a leaf) may dispatch a flush, so resolve operands
        # before taking the lock. A pending raw popcount materializes
        # before further use: its lanes are per-lane partial counts that
        # only become the word count at the materialize fold.
        def _needs_fold(x):
            return (x._graph.raw
                    and x._graph.layout.raw_lanes_per_word == 2
                    and x._graph.ops[x._op_idx][0] == "popcount")

        resolved = [x.materialize() if isinstance(x, LazyArray)
                    and (not (x._value is None and x._graph is not None
                              and x._graph is self._graph)
                         or _needs_fold(x))
                    else x for x in operands]
        with self._lock:
            g = self._graph
            if g is None:
                g = self._graph = _OpGraph(
                    n, self.layout.word_bits if raw else self.width,
                    self.layout, raw=raw, cache=self._leaf_cache)
                if self.tracer is not None:
                    g.t_start = time.perf_counter_ns()
            if self.tracer is not None:
                self.counters.inc("engine.ops_recorded")
                self.counters.inc(f"engine.op.{opcode}")
                if raw:
                    self.counters.inc("engine.raw_ops")
            args = []
            for x in resolved:
                if isinstance(x, LazyArray) and x._value is None \
                        and x._graph is g:
                    args.append(("op", x._op_idx))
                else:
                    arr = x.materialize() if isinstance(x, LazyArray) else x
                    args.append(g.leaf_id(arr))
            out = LazyArray(self, g, len(g.ops), shape)
            g.add_op(opcode, tuple(args), param, out, internal=internal)
            reason = None
            if not defer_flush \
                    and not getattr(self._local, "no_autoflush", False):
                reason = self._graph_over_threshold(g)
                if reason and self.tracer is not None:
                    self.counters.inc(f"engine.autoflush.{reason}")
        if reason:
            self.flush()  # auto-flush: `out` is live, materializes
        return out

    def _graph_over_threshold(self, g: _OpGraph) -> str | None:
        """Auto-flush policy: graph size (recorded ops) and estimated
        memory (one layout word per lane per held value). Returns the
        trigger name ("ops"/"memory") or None."""
        if self.flush_threshold is not None \
                and len(g.ops) >= self.flush_threshold:
            return "ops"
        if self.flush_memory_bytes is not None:
            est = g.layout.nbytes_per_word * g.n \
                * (len(g.leaves) + len(g.ops))
            if est >= self.flush_memory_bytes:
                return "memory"
        return None

    def flush(self) -> None:
        """Materialize the calling context's pending op graph through the
        fused pipeline (one transpose in, one fused program, one transpose
        out). Drains graphs parked by earlier failed flushes first. A
        failure parks the graph on the retry list (never back into a
        recording slot, so the restore cannot interleave with another
        client's recording) and re-raises. Never touches the cost plane —
        every op was charged at record time."""
        while True:
            g = self._take_next(self._ctx_key())
            if g is None:
                return
            self._dispatch_graph(g)

    def flush_all(self) -> None:
        """Flush every client context's pending graph, drain the retry
        list, and wait out in-flight async flushes (``Device.flush`` /
        clean ``with`` exit). Failures propagate like :meth:`flush`."""
        while True:
            with self._lock:
                futs = list(self._inflight.values())
            for f in futs:
                f.result()
            g = self._take_next(None)
            if g is None:
                with self._lock:
                    # An entry whose future resolved is stale (its
                    # registration raced the worker's pop): drop it.
                    for k, f in list(self._inflight.items()):
                        if f.done():
                            del self._inflight[k]
                    if not self._inflight:
                        return
                continue
            self._dispatch_graph(g)

    def flush_async(self) -> FlushHandle:
        """Compile + dispatch the pending graph off the calling thread.

        The record-side half (dead-code scan, program normalization, leaf
        staging) runs on the caller, so at most two flushes are staged at
        once (double buffering: the caller stages flush k+1 while the
        worker dispatches k; a third call blocks). The dispatch half runs
        on the engine's single flush worker thread, under the caller's
        CUDA device and current stream, so its uploads and kernel launches
        queue behind the caller's own work. Returns a :class:`FlushHandle`;
        ``result()`` re-raises a failed dispatch after parking the graph
        for retry exactly like a failed synchronous flush."""
        batch: list[_OpGraph] = []
        with self._lock:
            while self._retry:
                batch.append(self._begin_flush(self._retry.pop(0)))
            g = self._slots.pop(self._ctx_key(), None)
            if g is not None and g.ops:
                batch.append(self._begin_flush(g))
        if not batch:
            return FlushHandle(None)
        staged = []
        try:
            for g in batch:
                staged.append((g, self._prepare_graph(g)))
        except BaseException:
            # Nothing reached the worker yet: park the whole batch, in
            # order, so a later flush/materialize retries it.
            with self._lock:
                self._park_graphs(batch)
            raise
        self._async_slots.acquire()
        try:
            fut = self._submit(self._async_run, staged)
        except BaseException:
            self._async_slots.release()
            with self._lock:
                self._park_graphs([g for g, _ in staged])
            raise
        with self._lock:
            for g, _ in staged:
                self._inflight[id(g)] = fut
        if fut.done():
            # The worker can finish before the entries above land (its
            # per-graph pops find nothing): drop them here so flush_all
            # never waits on an already-finished dispatch.
            with self._lock:
                for g, _ in staged:
                    self._inflight.pop(id(g), None)
        if self.tracer is not None:
            self.counters.inc("engine.flush_async")
        return FlushHandle(fut)

    def close(self) -> None:
        """Shut the async flush worker down (waits for in-flight
        dispatches). Safe to call repeatedly; the worker is recreated
        lazily if ``flush_async`` is used again."""
        with self._lock:
            ex, self._executor = self._executor, None
        if ex is not None:
            ex.shutdown(wait=True)

    # -- flush plumbing -------------------------------------------------- #

    def _begin_flush(self, g: _OpGraph) -> _OpGraph:
        """Transition a detached graph to the flushing state (lock held)."""
        g.state = "flushing"
        g.done = threading.Event()
        return g

    def _park_graphs(self, graphs) -> None:
        """Park failed/abandoned flushes for retry (lock held): FIFO on
        the retry list, never back into a recording slot."""
        for g in graphs:
            g.state = "queued"
            self._retry.append(g)
            if g.done is not None:
                g.done.set()

    def _take_next(self, key) -> "_OpGraph | None":
        """Pop the next graph to dispatch: retries first, then ``key``'s
        slot (or any slot when ``key`` is None, for flush_all)."""
        with self._lock:
            if self._retry:
                return self._begin_flush(self._retry.pop(0))
            if key is None:
                for k in list(self._slots):
                    return self._begin_flush(self._slots.pop(k))
                return None
            g = self._slots.pop(key, None)
            return None if g is None else self._begin_flush(g)

    def _ensure_executor(self) -> ThreadPoolExecutor:
        with self._lock:
            if self._executor is None:
                self._executor = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="pum-flush")
            return self._executor

    def _submit(self, fn, *args):
        """Run ``fn(*args)`` on the flush worker under the calling
        thread's CUDA device and current stream for this engine (a worker
        thread otherwise starts on device 0's default stream)."""
        where = None
        if self.device.type == "cuda":
            dev = self.device
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            where = (dev, torch.cuda.current_stream(dev))

        def run():
            with _cuda_scope(where):
                return fn(*args)

        return self._ensure_executor().submit(run)

    def _async_run(self, staged) -> None:
        """Worker-side half of flush_async: dispatch each staged graph."""
        try:
            for g, st in staged:
                try:
                    if st is not None:
                        self._run_staged(g, st)
                    with self._lock:
                        g.state = "done"
                except BaseException:
                    with self._lock:
                        self._park_graphs([g])
                    raise
                finally:
                    if g.done is not None:
                        g.done.set()
                    with self._lock:
                        self._inflight.pop(id(g), None)
        finally:
            self._async_slots.release()

    def _dispatch_graph(self, g: _OpGraph) -> None:
        """Prepare + dispatch one detached graph on the calling thread."""
        try:
            st = self._prepare_graph(g)
            if st is not None:
                self._run_staged(g, st)
            with self._lock:
                g.state = "done"
        except BaseException:
            # Keep pending handles recoverable after a transient failure:
            # park the graph so a later flush/materialize retries it.
            with self._lock:
                self._park_graphs([g])
            raise
        finally:
            if g.done is not None:
                g.done.set()

    def _materialize_graph(self, g: _OpGraph) -> None:
        """Make ``g``'s live handles hold values, wherever ``g`` is in the
        flush lifecycle: still recording (any context's slot), parked for
        retry, in flight on the async worker (wait on it), or done."""
        fut = None
        with self._lock:
            st = g.state
            if st == "recording":
                for k, v in list(self._slots.items()):
                    if v is g:
                        del self._slots[k]
                        break
                self._begin_flush(g)
            elif st == "queued":
                self._retry.remove(g)
                self._begin_flush(g)
            elif st == "flushing":
                fut = self._inflight.get(id(g))
        if st in ("recording", "queued"):
            self._dispatch_graph(g)
        elif st == "flushing":
            # Another thread is dispatching this graph (sync or async):
            # wait for it; if it failed and parked the graph, retry here.
            if fut is not None:
                fut.result()
            elif g.done is not None:
                g.done.wait()
            if g.state == "queued":
                self._materialize_graph(g)
        # st == "done": values are set (or the flush had no live outputs).

    def _prepare_graph(self, g: _OpGraph):
        """Record-side half of a flush: dead-code scan, program build +
        normalization, leaf staging. Returns None when nothing in the
        graph is live."""
        if not g.ops:
            return None
        tr = NULL_TRACER if self.tracer is None else self.tracer
        if g.t_start is not None:
            tr.add_span("flush.record", g.t_start, time.perf_counter_ns(),
                        n_ops=len(g.ops), n_leaves=len(g.leaves),
                        raw=g.raw)
        live = [wr() for wr in g.results]
        # Handles that died unreferenced are dead code (their cost was
        # still charged, as in eager mode).
        out_idx = [i for i, lz in enumerate(live) if lz is not None]
        if not out_idx:
            return None
        n_leaves = len(g.leaves)

        def vid(tag):  # combined id space: leaves first, then ops
            return tag[1] if tag[0] == "leaf" else n_leaves + tag[1]

        with tr.span("flush.optimize", n_ops_in=len(g.ops)) as sp_opt:
            program = FusedProgram(
                width=g.width, n_inputs=n_leaves,
                ops=tuple(FusedOp(opcode, tuple(vid(a) for a in args),
                                  param)
                          for opcode, args, param in g.ops),
                outputs=tuple(n_leaves + i for i in out_idx),
                layout=g.layout)
            program, out_pos, leaf_map = optimize_program(program)
            sp_opt.args["n_ops_out"] = len(program.ops)
        with tr.span("flush.leaf_upload", n_leaves=len(leaf_map)) as sp_up:
            staged_b = skipped_b = hits = 0
            leaves = []
            for li in leaf_map:
                leaf = g.leaves[li]
                if leaf.entry is not None:
                    hits += 1
                    skipped_b += leaf.entry.nbytes
                    leaves.append(leaf.entry)
                else:
                    staged_b += leaf.wire.nbytes
                    leaves.append(leaf.wire if leaf.seed is None
                                  else leaf.seed)
            if self.tracer is not None:
                sp_up.args["bytes_staged"] = staged_b
                sp_up.args["bytes_skipped"] = skipped_b
                c = self.counters
                if hits:
                    c.inc("engine.leaf_cache.hits", hits)
                if len(leaf_map) - hits:
                    c.inc("engine.leaf_cache.misses", len(leaf_map) - hits)
                if g.cache_evictions:
                    c.inc("engine.leaf_cache.evictions", g.cache_evictions)
                    g.cache_evictions = 0
                if g.elided_bytes:
                    c.inc("engine.snapshot_bytes_elided", g.elided_bytes)
                    g.elided_bytes = 0
                if staged_b:
                    c.inc("engine.leaf_bytes_staged", staged_b)
        return (program, out_pos, live, out_idx, leaves)

    def _run_staged(self, g: _OpGraph, staged) -> None:
        """Dispatch-side half of a flush: build, upload, run, materialize."""
        program, out_pos, live, out_idx, leaves = staged
        self.last_program = program
        tr = NULL_TRACER if self.tracer is None else self.tracer
        with tr.span("flush.compile") as sp_c:
            if self.tracer is not None:
                misses0 = _fused._cached_pipeline.cache_info().misses
            pipeline = get_pipeline(program, device=self.device,
                                    donate=self.donate_leaves,
                                    backend=self.fused_backend)
            if self.tracer is not None:
                hit = (_fused._cached_pipeline.cache_info().misses
                       == misses0)
                self.counters.inc("engine.pipeline_cache.hit" if hit
                                  else "engine.pipeline_cache.miss")
                sp_c.args["cache"] = "hit" if hit else "miss"
        rel = self.reliability
        with tr.span("flush.dispatch", n_ops=len(program.ops),
                     n_lanes=g.n) as sp_d:
            tensors = self._resolve_cached_leaves(g, pipeline, leaves)
            if rel is not None and rel.inject:
                # Fault-injection hook: the pipeline runs once clean, then
                # the reliability plane votes over map-driven faulty
                # replicas, retrying/escalating on weak margins.
                voted = with_fault_injection(
                    pipeline,
                    lambda o: rel.correct(o, program, g.n, span=sp_d))
                outs = voted(*tensors)
            else:
                outs = pipeline(*tensors)
            # Donating flushes keep no uploaded leaf past the dispatch.
            del tensors
        with tr.span("flush.materialize", n_outputs=len(out_idx)):
            host = [g.layout.from_wire(o) for o in outs]
            for i, pos in zip(out_idx, out_pos):
                lz = live[i]
                lanes = host[pos][:g.n]
                if g.raw:  # re-join the lanes of each caller uint64 word
                    val = g.layout.join_raw(lanes)
                    if g.ops[i][0] == "popcount" \
                            and g.layout.raw_lanes_per_word == 2:
                        # A raw popcount's lanes hold per-lane partial
                        # counts: the word's count is their SUM.
                        val = ((val >> np.uint64(32))
                               + (val & np.uint64(0xFFFFFFFF)))
                else:
                    val = lanes.astype(np.uint64)
                lz._value = val.reshape(lz.shape)
                # A materialized handle never needs the graph again.
                lz._graph = None
                lz._engine = None
        if self.tracer is not None:
            self.counters.inc("engine.flushes")
            self.counters.observe("engine.flush_lanes", g.n)
            self.counters.observe("engine.flush_ops", len(program.ops))
        if self.autotuner is not None:
            # Per-flush decision point (sync or on the flush worker, under
            # the caller's stream): the online autotuner counts windows and
            # takes counter deltas here; its own guard stops a re-tune
            # from recursing.
            self.autotuner.on_flush(self)

    def _resolve_cached_leaves(self, g: _OpGraph, pipeline, leaves) -> list:
        """Staged leaves -> int32 tensors on the engine's device:

        * a leaf-cache entry serves its kept device tensor when the
          pipeline wants one (``pipeline.wants_device``) and the flush
          does not donate — repeat flushes upload nothing;
        * everything else uploads its host wire afresh; a donating flush
          also drops the entry's device residency, so donated buffers are
          never cached and cached ones are never donated.
        """
        cache = self._leaf_cache
        wants = getattr(pipeline, "wants_device", None)
        wire_words = (g.n + g._pad) * g.layout.wire_words_per_lane
        use_dev = (not self.donate_leaves and wants is not None
                   and wants(wire_words))
        out = []
        for x in leaves:
            if isinstance(x, _LeafCacheEntry):
                if use_dev:
                    out.append(cache.device_buffer(x))
                    continue
                if self.donate_leaves:
                    cache.drop_device(x)
                x = x.wire
            out.append(_upload(x, self.device))
        return out

    _PLANEWISE = frozenset({"and", "or", "xor"})

    def _binary(self, kind: str, opcode: str, a, b, np_fn):
        """kind prices the op (cost plane); opcode names it in the fused
        ISA."""
        a, b = self._coerce(a), self._coerce(b)
        self._charge(kind, a.size)
        if self._can_fuse(a, b):
            if opcode in self._PLANEWISE and self._use_raw((a, b)):
                return self._record(opcode, (a, b), raw=True)
            return self._record(opcode, (a, b))
        return self._run2(opcode, self._force(a), self._force(b), np_fn)

    def _and(self, a, b):
        return self._binary("and2", "and", a, b, lambda x, y: x & y)

    def _or(self, a, b):
        return self._binary("or2", "or", a, b, lambda x, y: x | y)

    def _xor(self, a, b):
        return self._binary("xor2", "xor", a, b, lambda x, y: x ^ y)

    def _add(self, a, b):
        return self._binary("add", "add", a, b,
                            lambda x, y: (x + y) & self._mask(self.width))

    def _sub(self, a, b):
        return self._binary("add", "sub", a, b,
                            lambda x, y: (x - y) & self._mask(self.width))

    def _mul(self, a, b):
        return self._binary("mul", "mul", a, b,
                            lambda x, y: (x * y) & self._mask(self.width))

    def _divpart(self, a, b, which: str):
        """div or mod: ONE restoring-division charge; in fused mode the op
        lowers to the shared ``divmod`` tuple op plus a selector."""
        a, b = self._coerce(a), self._coerce(b)
        self._charge("div", a.size)
        if self._can_fuse(a, b):
            pair = self._record("divmod", (a, b), defer_flush=True,
                                internal=True)
            return self._record("fst" if which == "div" else "snd", (pair,))
        with np.errstate(divide="ignore", invalid="ignore"):
            fn = (lambda x, y: x // y) if which == "div" \
                else (lambda x, y: x % y)
            return self._run2(which, self._force(a), self._force(b), fn)

    def _div(self, a, b):
        return self._divpart(a, b, "div")

    def _mod(self, a, b):
        return self._divpart(a, b, "mod")

    def _divmod(self, a, b):
        """(quotient, remainder) for ONE division charge."""
        a, b = self._coerce(a), self._coerce(b)
        self._charge("div", a.size)
        if self._can_fuse(a, b):
            pair = self._record("divmod", (a, b), defer_flush=True,
                                internal=True)
            q = self._record("fst", (pair,), defer_flush=True)
            r = self._record("snd", (pair,))
            return q, r
        with np.errstate(divide="ignore", invalid="ignore"):
            af, bf = self._force(a), self._force(b)
            if self._alu is not None and af.size <= self._alu.words * 32:
                # One restoring-division pass on the sim ALU yields both.
                # The ALU's divider assumes nonzero divisors; mask those
                # lanes to 0 to keep the engine-wide x//0 == x%0 == 0
                # contract (unsigned NumPy semantics) on every backend.
                va, vb = self._alu_load2(af, bf)
                vq, vr = self._alu.div(va, vb)
                zero = bf == 0
                out = (np.where(zero, np.uint64(0),
                                self._alu_store(vq, af)),
                       np.where(zero, np.uint64(0),
                                self._alu_store(vr, af)))
                for v in (vq, vr, va, vb):
                    self._alu.free(v)  # return the subarray rows
                return out
            return (af // bf, af % bf)

    def _less_than(self, a, b):
        a, b = self._coerce(a), self._coerce(b)
        self._charge("compare", a.size)
        if self._can_fuse(a, b):
            return self._record("less", (a, b))
        return (self._force(a) < self._force(b)).astype(np.uint64)

    def _popcount(self, a, width: int | None = None):
        a = self._coerce(a)
        w = width or self.width
        self._charge("popcount", a.size, n_planes=w)
        if self._can_fuse(a):
            if self._use_raw((a,)):
                return self._record("popcount", (a,), raw=True)
            return self._record("popcount", (a,))
        return _vec_popcount(self._force(a))

    def _reduce_bits(self, a, kind: str, width: int | None = None):
        a = self._coerce(a)
        w = width or self.width
        self._charge(f"reduce_{kind}", a.size, n_planes=w)
        if self._can_fuse(a):
            return self._record(f"reduce_{kind}", (a,),
                                param=w if kind == "and" else 0)
        a = self._force(a)
        if kind == "and":
            return (a == self._mask(w)).astype(np.uint64)
        if kind == "or":
            return (a != 0).astype(np.uint64)
        pc = _vec_popcount(a)
        return pc & np.uint64(1)

    def _alu_load2(self, a: np.ndarray, b: np.ndarray):
        """Both operands into sim-ALU vertical registers (one row budget:
        ``alu.words * 32`` lanes — callers guard the size)."""
        alu = self._alu
        return (alu.load(a.ravel()[: alu.words * 32]),
                alu.load(b.ravel()[: alu.words * 32]))

    def _alu_store(self, vec, like: np.ndarray) -> np.ndarray:
        """Read a sim-ALU register back into ``like``'s size and shape."""
        return self._alu.store(vec)[: like.size].reshape(like.shape)

    def _run2(self, name, a, b, np_fn):
        """An eager binary op: on the sim ALU when one is attached and the
        operands fit one chip row (``alu.words * 32`` lanes), else — as in
        the reference — on the host's NumPy words."""
        if self._alu is not None and a.size <= self._alu.words * 32:
            alu = self._alu
            va, vb = self._alu_load2(a, b)
            fn = {"and": alu.and_, "or": alu.or_, "xor": alu.xor,
                  "add": alu.add, "sub": alu.sub, "mul": alu.mul}.get(name)
            if fn is None and name in ("div", "mod"):
                # Zero-divisor lanes yield 0 on every backend (the ALU's
                # restoring divider assumes b != 0 elementwise).
                q, r = alu.div(va, vb)
                out = self._alu_store(q if name == "div" else r, a)
                out = np.where(b == 0, np.uint64(0), out)
                vecs = (q, r, va, vb)
            else:
                res = fn(va, vb)
                out = self._alu_store(res, a)
                vecs = (res, va, vb)
            for v in vecs:  # return the subarray rows to the pool: the
                alu.free(v)  # engine owns no Vec past the op
            return out
        return np_fn(a, b)

    # ------------------------------------------------------------------ #

    @property
    def latency_ms(self) -> float:
        return self.stats.latency_ns * 1e-6

    def reset_stats(self) -> None:
        with self._lock:
            self._stats_shards.clear()


_M1 = np.uint64(0x5555555555555555)
_M2 = np.uint64(0x3333333333333333)
_M4 = np.uint64(0x0F0F0F0F0F0F0F0F)
_H01 = np.uint64(0x0101010101010101)


def _vec_popcount(a: np.ndarray) -> np.ndarray:
    """Fixed-iteration SWAR popcount (Hacker's Delight 5-2)."""
    a = np.asarray(a, np.uint64).copy()
    a -= (a >> np.uint64(1)) & _M1
    a = (a & _M2) + ((a >> np.uint64(2)) & _M2)
    a = (a + (a >> np.uint64(4))) & _M4
    return (a * _H01) >> np.uint64(56)
