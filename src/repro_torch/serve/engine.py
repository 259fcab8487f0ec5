"""Batched serving engine: continuous batching over prefill/decode steps.

The port's copy of ``repro.serve.engine``. Slot-based scheduler: a fixed
decode batch of ``max_batch`` slots; arriving requests prefill into a
free slot's cache region; every engine tick runs one decode step for all
slots. EOS/length-stop frees slots.

The model, its caches and the PuM device all live on ``device`` (the
card unless the caller passes ``device="cpu"``). PyTorch runs eagerly,
so the reference's ``jax.jit`` step closures become plain calls under
``torch.no_grad``; the caches are updated in place.

Bulk slot bookkeeping routes through the PuM dataplane by default
(``pum_bulk=True``): the per-tick stop predicate — EOS match, generated
length cap, context-length cap, across all slots — is one fused PuM
program (xor/reduce_or equality + less-than compares) captured once with
``Device.capture`` at construction. Every steady tick *replays* the
compiled pipeline with zero re-recording; on a CUDA device each replay
launches the bit-transpose kernel at both ends and the fused-program
kernel once. Results are bit-identical to the host path;
``ServeEngine.pum.stats`` prices the bookkeeping in DRAM.
``pum_bulk=False`` restores the pure-host loop.

``async_stop=True`` (requires ``pum_bulk``) dispatches each tick's stop
predicate on the device's flush worker at tick end and resolves it at
the start of the next tick, before admission and decode. Token streams
are bit-identical to the synchronous mode.

``telemetry=True`` records the reference's per-tick observability —
``serve.ticks``, the ``serve.active_slots`` and ``serve.stop_flush_ns``
histograms in ``ServeEngine.counters``, ``serve.tick`` and
``serve.stop_predicate`` spans (with the PuM device's flush phases
nested inside) in ``ServeEngine.tracer`` — plus two spans of the port's
own inside each tick: ``serve.admit`` (prefill and the cache write of
new requests) and ``serve.decode`` (the decode step, ending when the
next tokens reach the host). Telemetry never perturbs token output and
is fully off by default.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

import repro_torch.pum as pum
from repro_torch.config.base import ModelConfig
from repro_torch.models.model import (decode_step, init_cache, init_params,
                                      prefill, torch_dtype)
from repro_torch.models.tree import tree_map
from repro_torch.telemetry import NULL_TRACER, CounterBank, Tracer


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # [T] int32
    max_new_tokens: int = 16
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False
    t_submit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params=None, max_batch: int = 4,
                 max_len: int = 256, eos_id: int = 1, seed: int = 0,
                 greedy: bool = True, pum_bulk: bool = True,
                 telemetry: bool = False, async_stop: bool = False,
                 device="cuda"):
        if async_stop and not pum_bulk:
            raise ValueError("async_stop requires pum_bulk=True (the stop "
                             "predicate runs on the PuM flush worker)")
        self.cfg = cfg
        self.device = torch.device(device)
        # Fused PuM device on the model's device for the stop masks.
        self.pum = (pum.device(width=32, fuse=True, device=self.device)
                    if pum_bulk else None)
        self.counters = CounterBank()
        self.tracer = Tracer() if telemetry else None
        self._tr = self.tracer if telemetry else NULL_TRACER
        self.telemetry = telemetry
        if telemetry and self.pum is not None:
            self.pum.engine.tracer = self.tracer
        self.params = params if params is not None else init_params(
            cfg, seed, device=self.device)
        self.max_batch = max_batch
        self.max_len = max_len
        self.eos_id = eos_id
        self.greedy = greedy
        self.caches = init_cache(cfg, max_batch, max_len,
                                 torch_dtype(cfg.dtype), device=self.device)
        self.pos = np.zeros(max_batch, np.int32)
        self.slot_req: list[Request | None] = [None] * max_batch
        self.cur_token = np.zeros(max_batch, np.int32)
        self.queue: list[Request] = []
        self.finished: list[Request] = []
        self.async_stop = async_stop
        # In-flight stop predicate from the previous tick (async_stop):
        # (CaptureHandle, active slots it was computed over).
        self._stop_pending: tuple | None = None
        if self.pum is not None:
            # Capture the fixed-shape stop predicate once: the warm-up
            # call records and compiles it, so steady ticks replay.
            self._stop_prog = self.pum.capture(self._stop_expr,
                                               name="serve.stop")
            self._stop_mask_pum([])
            self.pum.reset_stats()

    # ------------------------------------------------------------------ #

    def close(self) -> None:
        """Shut the PuM device's flush worker down (idempotent)."""
        if self.pum is not None:
            self.pum.close()

    def submit(self, req: Request) -> None:
        req.t_submit = time.perf_counter()
        self.queue.append(req)

    def _free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    @torch.no_grad()
    def _admit(self) -> None:
        """Prefill queued requests into free slots (one-at-a-time prefill;
        batched decode)."""
        for slot in self._free_slots():
            if not self.queue:
                break
            req = self.queue.pop(0)
            t = len(req.prompt)
            tokens = torch.as_tensor(np.asarray(req.prompt, np.int64),
                                     device=self.device)[None]
            logits, caches_b1, _ = prefill(self.cfg, self.params,
                                           {"tokens": tokens}, self.max_len)
            index = torch.tensor([slot], device=self.device)

            # Copy the single-request cache into this slot of the batch
            # cache. The batch axis is the first axis where the two leaf
            # shapes differ (both layouts), axis 0 where none does — the
            # reference's rule, so even its max_batch=1 result is kept.
            def write(slot_c, one_c):
                ax = next((i for i, (a, b) in enumerate(
                    zip(slot_c.shape, one_c.shape)) if a != b), 0)
                slot_c.index_copy_(ax, index, one_c.narrow(ax, 0, 1))

            tree_map(write, self.caches, caches_b1)
            tok = int(torch.argmax(logits[0, :self.cfg.vocab_size]))
            req.out_tokens.append(tok)
            req.t_first = time.perf_counter()
            self.slot_req[slot] = req
            self.pos[slot] = t
            self.cur_token[slot] = tok

    def _stop_expr(self, n_out, cap, pos, tok):
        """The stop predicate as a function of PumArrays, captured once.
        Per slot: ``tok == eos or n_generated >= max_new or pos >=
        max_len-1`` (``^`` + ``reduce_or`` equality, ``<`` length caps) —
        the host conditional of :meth:`tick`."""
        m = self.max_batch
        ones = np.ones(m, np.uint64)
        limit = np.full(m, self.max_len - 1, np.uint64)
        stop = ((n_out < cap) ^ ones) \
            | ((pos < limit) ^ ones)                # len cap | ctx cap
        if 0 <= self.eos_id < (1 << self.pum.width):
            eos = np.full(m, self.eos_id, np.uint64)
            neq = (tok ^ eos).reduce_bits("or")
            stop = stop | (neq ^ ones)              # EOS
        return stop

    def _stop_operands(self, active: list[int]) -> tuple[np.ndarray, ...]:
        """The per-slot predicate operands, padded to ``max_batch``
        (inactive slots get never-stopping dummies), so every tick hits
        the one captured shape."""
        m = self.max_batch
        n_out = np.zeros(m, np.uint64)
        cap = np.ones(m, np.uint64)
        pos = np.zeros(m, np.uint64)
        tok = np.zeros(m, np.uint64)
        for s in active:
            req = self.slot_req[s]
            n_out[s] = len(req.out_tokens)
            cap[s] = req.max_new_tokens
            pos[s] = self.pos[s]
            tok[s] = self.cur_token[s]
        return n_out, cap, pos, tok

    def _stop_mask_pum(self, active: list[int]) -> list[bool]:
        """Synchronous bulk stop predicate: replay the captured pipeline
        and filter to the active slots."""
        full = self._stop_prog(*self._stop_operands(active)).astype(bool)
        return [bool(full[s]) for s in active]

    def tick(self) -> int:
        """One engine iteration: admit + one decode step.
        Returns number of active slots."""
        with self._tr.span("serve.tick") as sp_tick:
            return self._tick_inner(sp_tick)

    def _resolve_stop(self) -> None:
        """Join the previous tick's in-flight stop predicate (async_stop)
        and free the slots it stopped, before admission and decode."""
        if self._stop_pending is None:
            return
        handle, active = self._stop_pending
        self._stop_pending = None
        full = handle.result().astype(bool)
        self._finish([bool(full[s]) for s in active], active)

    def _finish(self, done, active: list[int]) -> None:
        for stop, slot in zip(done, active):
            if stop:
                req = self.slot_req[slot]
                req.done = True
                req.t_done = time.perf_counter()
                self.finished.append(req)
                self.slot_req[slot] = None

    @torch.no_grad()
    def _decode_tokens(self) -> np.ndarray:
        """One decode step over all slots; the greedy next token per slot
        (first maximum over the real vocabulary), on the host."""
        logits, self.caches = decode_step(
            self.cfg, self.params, self.caches,
            torch.as_tensor(self.cur_token.astype(np.int64),
                            device=self.device),
            torch.as_tensor(self.pos.astype(np.int64), device=self.device))
        return logits[:, :self.cfg.vocab_size].argmax(-1).cpu().numpy()

    def _tick_inner(self, sp_tick) -> int:
        self._resolve_stop()
        with self._tr.span("serve.admit"):
            self._admit()
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if self.telemetry:
            self.counters.inc("serve.ticks")
            self.counters.observe("serve.active_slots", len(active))
            sp_tick.args["active_slots"] = len(active)
        if not active:
            return 0
        with self._tr.span("serve.decode"):
            toks = self._decode_tokens()
        for slot in active:
            req = self.slot_req[slot]
            tok = int(toks[slot])
            req.out_tokens.append(tok)
            self.pos[slot] += 1
            self.cur_token[slot] = tok
        done = None
        with self._tr.span("serve.stop_predicate",
                           path="pum" if self.pum is not None
                           else "host") as sp:
            if self.pum is None:
                done = np.array(
                    [self.cur_token[s] == self.eos_id
                     or len(self.slot_req[s].out_tokens)
                     >= self.slot_req[s].max_new_tokens
                     or self.pos[s] >= self.max_len - 1 for s in active])
            elif self.async_stop:
                # Dispatch on the flush worker; resolves at the start of
                # the next tick (the span measures only the submit).
                self._stop_pending = (
                    self._stop_prog.call_async(*self._stop_operands(active)),
                    active)
            else:
                done = self._stop_mask_pum(active)
        if self.telemetry:
            self.counters.observe("serve.stop_flush_ns", sp.dur_ns)
        if done is not None:
            self._finish(done, active)
        return len(active)

    def run_until_drained(self, max_ticks: int = 10_000) -> list[Request]:
        ticks = 0
        # Under async_stop, occupied slots may only be freed by the next
        # tick's resolve: the loop runs that one extra (no-decode) tick.
        while (self.queue or any(r is not None for r in self.slot_req)) \
                and ticks < max_ticks:
            self.tick()
            ticks += 1
        self._resolve_stop()
        return self.finished
