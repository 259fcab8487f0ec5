"""Cross-call program capture: record once, replay with zero re-recording.

The port's copy of ``repro.pum.capture``.
:meth:`repro_torch.pum.Device.capture` wraps a function of PumArrays into
a :class:`CapturedProgram`. The first call records the function's ops
into a dedicated client context, normalizes the graph (CSE + dead-code
pruning) and compiles the fused pipeline exactly like a flush; every later
call with the same input shapes *replays* the compiled pipeline directly —
no graph recording, no normalization, no pipeline-cache probe — rebinding
only the input leaves. Constants captured from the closure upload once,
at record time, and stay on the device as tensors the recording owns, so
a replay uploads only the inputs that miss the leaf cache (none when the
caller passes the same buffers again). This is the ``pum.jit`` analogue
of PULSAR's chained staging: the command-program structure is paid once,
steady-state calls pay only the data movement.

The cost plane stays invariant: the charge recipe logged during recording
is replayed on every call, so ``Device.stats`` advances exactly as if the
function had been re-recorded (bit-identical totals, tested).

Contract:

  * the device must be fused (``fuse=True``); eager devices raise;
  * inputs are uint64 arrays (or coercible); outputs are the function's
    PumArray results, returned as materialized uint64 ndarrays;
  * value-mode only — a function whose ops route through the raw
    packed-bitmap path raises at capture time;
  * reliability *fault injection* is unsupported (the vote/retry loop
    re-plans per flush); calibrated planning without injection is fine;
  * a new input *shape* tuple re-records (one cache entry per shape);
    mutating a captured closure constant after recording is undefined —
    constants are snapshotted once.

>>> import numpy as np
>>> import repro_torch.pum as pum
>>> dev = pum.device(width=16, fuse=True, device="cpu")
>>> prog = dev.capture(lambda x, y: (x + y) * x)
>>> a = np.arange(8, dtype=np.uint64); b = a[::-1].copy()
>>> prog(a, b)                       # first call: records + compiles
array([ 0,  7, 14, 21, 28, 35, 42, 49], dtype=uint64)
>>> prog(b, a)                       # replay: same shapes, new data
array([49, 42, 35, 28, 21, 14,  7,  0], dtype=uint64)
>>> prog.n_records, prog.n_replays
(1, 1)
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np

from repro_torch.core import engine as _engine
from repro_torch.core.engine import LazyArray, _stage_wire
from repro_torch.kernels.fused_program import (FusedOp, FusedProgram,
                                               get_pipeline, optimize_program)


@dataclasses.dataclass
class _Recording:
    """One compiled shape-specialization of a captured function."""
    pipeline: object                 # compiled fused pipeline
    plan: list                       # per pipeline input: ("in", i) |
    #                                  ("const", int32 tensor on the device)
    out_slots: list[int]             # pipeline output position per result
    out_shapes: list[tuple]
    single: bool                     # fn returned one array (not a tuple)
    n: int                           # dataplane lane count
    pad: int
    width: int
    layout: object
    recipe: tuple                    # charge log to replay per call
    fp_idx: object = None            # 257-sample fingerprint index (cache)


class CaptureHandle:
    """Future-like handle for :meth:`CapturedProgram.call_async`."""

    __slots__ = ("_future", "_value")

    def __init__(self, future=None, value=None):
        self._future = future
        self._value = value

    def done(self) -> bool:
        return self._future is None or self._future.done()

    def result(self, timeout: float | None = None):
        """The captured function's outputs (uint64 ndarrays)."""
        if self._future is not None:
            return self._future.result(timeout)
        return self._value

    def __repr__(self) -> str:
        state = "done" if self.done() else "in-flight"
        return f"CaptureHandle({state})"


class CapturedProgram:
    """A function of PumArrays, compiled once per input-shape signature."""

    def __init__(self, device, fn, name: str | None = None):
        if not device.engine.fuse:
            raise ValueError(
                "capture requires a fused device (fuse=True): an eager "
                "device has no program to record")
        rel = device.engine.reliability
        if rel is not None and rel.inject:
            raise ValueError(
                "capture cannot replay under reliability fault injection "
                "(the vote/retry loop re-plans per flush); capture before "
                "enabling inject, or flush normally")
        self._device = device
        self._fn = fn
        self.name = name or getattr(fn, "__name__", "captured")
        self._ctx = f"capture-{id(self):x}"
        self._lock = threading.Lock()
        self._recordings: dict[tuple, _Recording] = {}
        self.n_records = 0
        self.n_replays = 0

    # ------------------------------------------------------------------ #

    @staticmethod
    def _normalize(inputs) -> list[np.ndarray]:
        return [np.ascontiguousarray(np.asarray(x, np.uint64))
                for x in inputs]

    def __call__(self, *inputs):
        norm = self._normalize(inputs)
        key = tuple(a.shape for a in norm)
        with self._lock:
            rec = self._recordings.get(key)
            if rec is None:
                rec, outs = self._record(norm)
                self._recordings[key] = rec
                self.n_records += 1
                return outs[0] if rec.single else tuple(outs)
        outs = self._replay(rec, norm)
        self.n_replays += 1
        return outs[0] if rec.single else tuple(outs)

    def call_async(self, *inputs) -> CaptureHandle:
        """Replay on the device's flush worker thread; returns a handle
        whose ``result()`` is the outputs. A first call for a new shape
        records synchronously (recording is caller-side by design), then
        returns an already-done handle."""
        norm = self._normalize(inputs)
        key = tuple(a.shape for a in norm)
        with self._lock:
            rec = self._recordings.get(key)
        if rec is None:
            outs = self(*inputs)
            return CaptureHandle(None, outs)

        def run():
            outs = self._replay(rec, norm)
            self.n_replays += 1
            return outs[0] if rec.single else tuple(outs)

        eng = self._device.engine
        return CaptureHandle(eng._submit(run))

    # ------------------------------------------------------------------ #

    def _record(self, norm: list[np.ndarray]):
        """First call for this shape signature: run ``fn`` in the capture
        client context, detach the recorded graph, compile it, and build
        the per-call leaf binding plan."""
        eng = self._device.engine
        recipe: list = []
        with eng.client(self._ctx):
            eng.flush()  # the capture context's slot must start empty
            eng._local.charge_log = recipe
            eng._local.no_autoflush = True
            try:
                pum_in = [self._device.asarray(a) for a in norm]
                outs = self._fn(*pum_in)
            finally:
                eng._local.charge_log = None
                eng._local.no_autoflush = False
            single = not isinstance(outs, (tuple, list))
            outs = [outs] if single else list(outs)
            with eng._lock:
                g = eng._graph
                eng._graph = None
        if g is None or not g.ops:
            raise ValueError(
                f"capture({self.name}): the function recorded no fused "
                f"ops (did it compute eagerly or return constants?)")
        if g.raw:
            raise ValueError(
                f"capture({self.name}): the function routed through the "
                f"raw packed-bitmap path (out-of-width operands); capture "
                f"is value-mode only — mask inputs to the device width")
        g.state = "done"  # never dispatched via flush; replays own it
        out_ops = []
        for o in outs:
            lz = getattr(o, "_data", o)
            if not (isinstance(lz, LazyArray) and lz._value is None
                    and lz._graph is g):
                raise ValueError(
                    f"capture({self.name}): every output must be a "
                    f"pending PumArray of the captured graph (got "
                    f"{type(o).__name__}; did an op auto-flush or "
                    f"materialize mid-function?)")
            out_ops.append(lz._op_idx)
        unique = list(dict.fromkeys(out_ops))
        n_leaves = len(g.leaves)

        def vid(tag):
            return tag[1] if tag[0] == "leaf" else n_leaves + tag[1]

        program = FusedProgram(
            width=g.width, n_inputs=n_leaves,
            ops=tuple(FusedOp(opcode, tuple(vid(a) for a in args), param)
                      for opcode, args, param in g.ops),
            outputs=tuple(n_leaves + i for i in unique),
            layout=g.layout)
        program, out_pos, leaf_map = optimize_program(program)
        # Replays rebind the leaves, so the pipeline may never donate its
        # input buffers (the staged constants are reused every call).
        pipeline = get_pipeline(program, device=eng.device, donate=False,
                                backend=eng.fused_backend)
        by_leaf = {g._leaf_ids[id(a)]: i for i, a in enumerate(norm)
                   if id(a) in g._leaf_ids}
        pad = (-g.n) % 32
        plan = []
        for li in leaf_map:
            if li in by_leaf:
                plan.append(("in", by_leaf[li]))
            else:
                # Closure constants upload once, from the graph's staged
                # wire (already padded; the record-time snapshot or a
                # cached upload's), and stay on the device.
                plan.append(("const", _engine._upload(g.stage_leaf(li),
                                                      eng.device)))
        rec = _Recording(
            pipeline=pipeline, plan=plan,
            out_slots=[out_pos[unique.index(i)] for i in out_ops],
            out_shapes=[getattr(o, "shape", ()) for o in outs],
            single=single, n=g.n, pad=pad, width=g.width, layout=g.layout,
            recipe=tuple(recipe), fp_idx=g._fp_idx)
        # First-call outputs come from one replay (the recording itself
        # already charged the cost plane through the ops in ``fn``).
        values = self._replay(rec, norm, charge=False)
        for o, v in zip(outs, values):
            lz = getattr(o, "_data", o)
            lz._value = v
            lz._graph = None
            lz._engine = None
        return rec, values

    def _replay(self, rec: _Recording, norm: list[np.ndarray],
                charge: bool = True) -> list[np.ndarray]:
        eng = self._device.engine
        cache = eng._leaf_cache
        wants = getattr(rec.pipeline, "wants_device", None)
        # Capture pipelines never donate, so cached device buffers are
        # safe to serve whenever the pipeline runs jitted.
        use_dev = cache is not None and wants is not None and wants(
            (rec.n + rec.pad) * rec.layout.wire_words_per_lane)
        hits = misses = 0
        leaves = []
        for kind, v in rec.plan:
            if kind == "const":
                leaves.append(v)
                continue
            arr = norm[v]
            rav = arr.ravel()
            if rav.size != rec.n:
                raise ValueError(
                    f"capture({self.name}): input {v} has {rav.size} "
                    f"lanes; this recording expects {rec.n}")
            entry = ckey = fp = None
            shared = rav.base is not None or rav is arr
            if cache is not None and shared and rav.size:
                fp = rav[rec.fp_idx]
                ckey = (rav.__array_interface__["data"][0], rav.nbytes,
                        rec.layout.name, False)
                entry = cache.lookup(ckey, fp)
            if entry is None:
                misses += 1
                if rec.width < 64 and rav.size \
                        and int(rav.max()) >> rec.width:
                    raise ValueError(
                        f"fused dataplane computes modulo 2**{rec.width};"
                        f" an operand has bits at or above bit "
                        f"{rec.width} — mask inputs to the engine width "
                        f"or use fuse=False")
                wire = _stage_wire(rav, rec.pad, rec.layout, copy=shared)
                if ckey is not None:
                    entry, _ = cache.insert(ckey, fp, wire)
                if entry is None:
                    leaves.append(_engine._upload(wire, eng.device))
                    continue
            else:
                hits += 1
            leaves.append(cache.device_buffer(entry) if use_dev
                          else _engine._upload(entry.wire, eng.device))
        if eng.tracer is not None and (hits or misses):
            if hits:
                eng.counters.inc("engine.leaf_cache.hits", hits)
            if misses:
                eng.counters.inc("engine.leaf_cache.misses", misses)
        if charge:
            # Charge into the capture's own client context: recording and
            # every replay land in ONE stats shard, so totals accumulate
            # in the exact float order a re-recording stream would.
            with eng.client(self._ctx):
                eng._replay_charges(rec.recipe)
            if eng.tracer is not None:
                eng.counters.inc("engine.capture.replay")
        outs = rec.pipeline(*leaves)
        values = []
        for slot, shape in zip(rec.out_slots, rec.out_shapes):
            lanes = rec.layout.from_wire(outs[slot])[:rec.n]
            values.append(lanes.astype(np.uint64).reshape(shape))
        return values

    def __repr__(self) -> str:
        return (f"CapturedProgram({self.name!r}, "
                f"{len(self._recordings)} shape(s), "
                f"records={self.n_records}, replays={self.n_replays})")
