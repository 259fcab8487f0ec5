"""Tuner — deterministic search over the discrete execution-config space.

The port's copy of ``repro.autotune.tuner``. ``Tuner.tune(profile,
config)`` enumerates every candidate knob combination the config's
device can actually run (fused backends resolved through the
``repro_torch.backends`` registry for ``config.device`` — the hand-
written kernels' ``vertical-cuda*`` on a CUDA device, the word
evaluator's ``words-torch*`` on the CPU — layouts covering the device
width, auto-flush bounds, REF postponing where a controller exists,
crossbar lookahead), scores each with the
:class:`~repro_torch.autotune.CostModel`, and freezes the winner into a
:class:`TunedPlan`. The search is exhaustive and the enumeration order
is sorted, so the same profile produces the same plan in any process;
the baseline (the config as-is) is scored first and candidates must
*strictly* beat the incumbent — no measured signal, no change.

Plans split their knobs into two tiers, preserving the engine's
cost-plane invariant:

* **execution knobs** — ``fused_backend``, plane layout,
  ``flush_threshold`` / ``flush_memory_bytes``, crossbar
  ``cmd_buffer_lookahead``, and ``fuse`` itself (the cost model prices
  eager per-op dispatch against fused staging + leaf-upload traffic, so
  a window dominated by snapshot bytes can recommend ``fuse=False``) —
  change only *where/when* programs run.
  ``TunedPlan.apply`` (and ``Device.autotune``) applies these by
  default: outputs and ``EngineStats`` are bit-identical to the static
  config.
* **cost-plane knobs** — ``ref_postponing`` — change the *modeled*
  refresh schedule and therefore ``EngineStats``. The tuner still
  searches and records them, but application is an explicit
  ``cost_plane=True`` opt-in.

:class:`DriftDetector` compares a fresh profile against the one a plan
was tuned on; :class:`OnlineAutotuner` hangs off the engine's per-flush
hook and closes the explore/exploit loop — re-tune when drift fires
(exploit the new regime) or every ``explore_every`` windows (explore).
"""

from __future__ import annotations

import dataclasses
import json
import threading

from repro_torch.autotune.cost import CostModel
from repro_torch.autotune.profile import WorkloadProfile

PLAN_SCHEMA = "repro_torch.autotune/1"

_KNOB_FIELDS = ("fused_backend", "word_bits", "flush_threshold",
                "flush_memory_bytes", "ref_postponing",
                "cmd_buffer_lookahead", "fuse")


@dataclasses.dataclass(frozen=True)
class SearchSpace:
    """The discrete config space the tuner enumerates.

    ``backends=None`` resolves the candidate list from the backend
    registry at tune time (every backend with the ``"fused"``
    capability *available on the config's device*); thresholds of
    ``None`` mean "unbounded".
    """

    backends: tuple | None = None
    layouts: tuple = (32, 64)
    flush_thresholds: tuple = (64, 256, 1024, 4096)
    flush_memory_bytes: tuple = (1 << 30,)
    ref_postponing: tuple = (1, 2, 4, 8)
    cmd_buffer_lookahead: tuple = (2, 8, 32)
    fuse: tuple = (True, False)


@dataclasses.dataclass(frozen=True)
class _Knobs:
    """One candidate point (also the baseline's shape)."""

    fused_backend: str
    word_bits: int
    flush_threshold: int | None
    flush_memory_bytes: int | None
    ref_postponing: int
    cmd_buffer_lookahead: int
    fuse: bool = True


@dataclasses.dataclass(frozen=True)
class TunedPlan:
    """Frozen output of one ``Tuner.tune`` call.

    Carries the winning knobs, the modeled score (and the baseline's,
    for the measured-improvement claim), the profile it was tuned on
    (the drift detector's reference), and JSON/npz persistence —
    ``save("plan.json")`` / ``save("plan.npz")`` round-trip through
    :meth:`load` exactly like ``ReliabilityMap``.
    """

    fused_backend: str
    word_bits: int = 32
    flush_threshold: int | None = 1024
    flush_memory_bytes: int | None = 1 << 30
    ref_postponing: int = 1
    cmd_buffer_lookahead: int = 8
    fuse: bool = True
    score_s: float = 0.0
    baseline_score_s: float = 0.0
    estimate: dict = dataclasses.field(default_factory=dict)
    profile: WorkloadProfile = dataclasses.field(
        default_factory=WorkloadProfile)
    schema: str = PLAN_SCHEMA

    # -- knob views ----------------------------------------------------- #

    def knobs(self) -> dict:
        """The searched knobs alone (no scores/profile)."""
        return {f: getattr(self, f) for f in _KNOB_FIELDS}

    def non_default(self, config) -> dict:
        """Knobs that differ from ``config``'s resolved values — what
        this plan would actually *change*. Empty means the static
        config already wins under the measured profile."""
        base = _Knobs(**_config_knobs(config))
        return {f: getattr(self, f) for f in _KNOB_FIELDS
                if getattr(self, f) != getattr(base, f)}

    def apply(self, config, *, cost_plane: bool = False):
        """``config`` with this plan's execution knobs applied (an
        ``EngineConfig``-shaped object with ``.replace``), including the
        ``fuse`` recommendation — fused and eager are bit-exact and
        stats-identical by construction, so the flip is still an
        execution knob (live devices pin their current ``fuse``; see
        ``Device._apply_plan``). Execution
        knobs never change outputs or ``EngineStats``; with
        ``cost_plane=True`` the REF-postponing recommendation is applied
        too (forcing ``controller="auto"`` when none is configured) —
        that changes the modeled refresh schedule, i.e. EngineStats."""
        changes = dict(fused_backend=self.fused_backend,
                       layout=self.word_bits,
                       flush_threshold=self.flush_threshold,
                       flush_memory_bytes=self.flush_memory_bytes,
                       cmd_buffer_lookahead=self.cmd_buffer_lookahead,
                       fuse=self.fuse)
        if cost_plane and self.ref_postponing != config.ref_postponing:
            changes["ref_postponing"] = self.ref_postponing
            if config.controller is None:
                changes["controller"] = "auto"
        return config.replace(**changes)

    def selection_override(self):
        """Context manager pinning this plan's fused backend in the
        ``repro_torch.backends`` registry (``selection_override``) — the
        hook for callers that reach ``get_pipeline`` without a
        ``Device``."""
        from repro_torch.backends import selection_override
        return selection_override("fused", self.fused_backend)

    # -- persistence ---------------------------------------------------- #

    def as_dict(self) -> dict:
        d = {f: getattr(self, f) for f in _KNOB_FIELDS}
        d.update(schema=self.schema, score_s=self.score_s,
                 baseline_score_s=self.baseline_score_s,
                 estimate=dict(self.estimate),
                 profile=self.profile.as_dict())
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "TunedPlan":
        d = dict(d)
        schema = d.get("schema", PLAN_SCHEMA)
        if schema != PLAN_SCHEMA:
            raise ValueError(f"unsupported plan schema {schema!r} "
                             f"(this build reads {PLAN_SCHEMA!r})")
        d["profile"] = WorkloadProfile.from_dict(d.get("profile", {}))
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    def save(self, path) -> None:
        """Persist as ``.json`` (canonical text) or ``.npz`` (the JSON
        embedded as a uint8 buffer, the ``ReliabilityMap`` idiom)."""
        blob = json.dumps(self.as_dict(), sort_keys=True, indent=2)
        if str(path).endswith(".npz"):
            import numpy as np
            np.savez_compressed(
                path, plan=np.frombuffer(blob.encode(), np.uint8))
        else:
            with open(path, "w") as f:
                f.write(blob + "\n")

    @classmethod
    def load(cls, path) -> "TunedPlan":
        if str(path).endswith(".npz"):
            import numpy as np
            with np.load(path) as z:
                blob = z["plan"].tobytes().decode()
        else:
            with open(path) as f:
                blob = f.read()
        return cls.from_dict(json.loads(blob))

    def __repr__(self) -> str:
        gain = (self.baseline_score_s / self.score_s
                if self.score_s else 1.0)
        return (f"TunedPlan({self.fused_backend!r}, u{self.word_bits}, "
                f"threshold={self.flush_threshold}, "
                f"ref={self.ref_postponing}, "
                f"lookahead={self.cmd_buffer_lookahead}, "
                f"modeled {gain:.2f}x vs static)")


def _config_knobs(config) -> dict:
    """The knob values ``config`` resolves to today (the baseline): its
    pinned fused backend, else the one its device selects."""
    layout = config.resolved_layout()
    name = config.fused_backend
    if name is None:
        from repro_torch.backends import select_backend
        name = select_backend(require="fused", device=config.device,
                              width=config.width, layout=layout).name
    return dict(fused_backend=name, word_bits=layout.word_bits,
                flush_threshold=config.flush_threshold,
                flush_memory_bytes=config.flush_memory_bytes,
                ref_postponing=config.ref_postponing,
                cmd_buffer_lookahead=config.cmd_buffer_lookahead,
                fuse=config.fuse)


class Tuner:
    """Exhaustive deterministic search; see module docstring."""

    def __init__(self, space: SearchSpace | None = None,
                 cost_model: CostModel | None = None,
                 drift_threshold: float = 0.5):
        self.space = space or SearchSpace()
        self.cost_model = cost_model or CostModel()
        self.drift_threshold = drift_threshold

    # -- candidate enumeration ------------------------------------------ #

    def _backend_names(self, config) -> list[str]:
        if self.space.backends is not None:
            return sorted(self.space.backends)
        import torch

        from repro_torch.backends import available_backends, get_backend
        device = torch.device(config.device)
        return sorted(
            n for n in available_backends("fused")
            if get_backend(n).available(device))

    def candidates(self, config) -> list[_Knobs]:
        """Every runnable candidate, in a deterministic order that lists
        the config's *current* value first in each dimension — ``tune``
        keeps the first incumbent among equal scores, so a knob only
        changes when some candidate is strictly better along it (no
        score signal, no gratuitous churn). REF postponing is only
        searched when the config already runs the ``"auto"`` controller
        — on the closed-form cost path a postponing change would
        silently mean nothing."""
        from repro_torch.backends import get_backend
        base = _config_knobs(config)

        def order(values, key, sort=lambda v: (v is None, v or 0)):
            return sorted(set(values), key=lambda v: (v != base[key],
                                                      sort(v)))

        sp = self.space
        refs = order(sp.ref_postponing if config.controller == "auto"
                     else (config.ref_postponing,), "ref_postponing")
        thresholds = order(sp.flush_thresholds, "flush_threshold")
        mem = order(sp.flush_memory_bytes, "flush_memory_bytes")
        lookaheads = order(sp.cmd_buffer_lookahead, "cmd_buffer_lookahead")
        layouts = order(sp.layouts, "word_bits")
        backends = order(self._backend_names(config), "fused_backend",
                         sort=lambda v: v)
        # Eager (fuse=False) candidates keep a valid backend/layout pair:
        # the plan stays fully applicable if the caller re-enables fusion.
        fuses = order(sp.fuse, "fuse", sort=lambda v: not v)
        out: list[_Knobs] = []
        for fu in fuses:
            for wb in layouts:
                if wb < config.width:
                    continue
                for name in backends:
                    spec = get_backend(name)
                    if "fused" not in spec.capabilities \
                            or spec.max_width < config.width \
                            or wb not in spec.layouts:
                        continue
                    for t in thresholds:
                        for m in mem:
                            for r in refs:
                                for la in lookaheads:
                                    out.append(_Knobs(
                                        fused_backend=name, word_bits=wb,
                                        flush_threshold=t,
                                        flush_memory_bytes=m,
                                        ref_postponing=r,
                                        cmd_buffer_lookahead=la,
                                        fuse=fu))
        return out

    # -- search --------------------------------------------------------- #

    def tune(self, profile: WorkloadProfile, config=None) -> TunedPlan:
        """Score the baseline and every candidate; freeze the winner.

        The baseline is the incumbent: a candidate must beat it (and
        every earlier candidate) *strictly*, so ties keep the static
        config and the sorted enumeration order makes the argmin unique
        — same profile, same plan, any process.
        """
        if config is None:
            from repro_torch.pum.config import EngineConfig
            config = EngineConfig()
        base = _Knobs(**_config_knobs(config))
        best, best_est = base, self.cost_model.estimate(profile, base)
        baseline_s = best_est.total_s
        for cand in self.candidates(config):
            est = self.cost_model.estimate(profile, cand)
            if est.total_s < best_est.total_s * (1.0 - 1e-9):
                best, best_est = cand, est
        return TunedPlan(
            **dataclasses.asdict(best), score_s=best_est.total_s,
            baseline_score_s=baseline_s, estimate=best_est.as_dict(),
            profile=profile)

    def should_retune(self, plan: TunedPlan,
                      profile: WorkloadProfile) -> bool:
        """Has the workload drifted from the profile ``plan`` was tuned
        on far enough to justify a re-tune?"""
        return DriftDetector(plan.profile,
                             threshold=self.drift_threshold).fired(profile)


class DriftDetector:
    """Counter-drift detector: compares a fresh window's profile against
    a baseline profile feature by feature.

    Fraction-valued features compare by absolute difference (they live
    in [0, 1]); magnitude features (lanes, graph depth) compare by
    relative change; the op mix compares by total-variation distance.
    ``drift`` is the max over all of these — ``fired`` when it reaches
    ``threshold`` (default 0.5: a feature moved half its scale).
    """

    _RELATIVE = ("lanes", "ops_per_flush", "leaf_bytes_per_flush")

    def __init__(self, baseline: WorkloadProfile,
                 threshold: float = 0.5):
        self.baseline = baseline
        self.threshold = threshold

    def drift(self, profile: WorkloadProfile) -> float:
        old = self.baseline.scalar_features()
        new = profile.scalar_features()
        worst = 0.0
        for k in sorted(old):
            o, n = old[k], new[k]
            if k in self._RELATIVE:
                d = abs(n - o) / max(abs(o), 1.0)
            else:
                d = abs(n - o)
            worst = max(worst, d)
        ops = set(self.baseline.op_mix) | set(profile.op_mix)
        tv = 0.5 * sum(abs(self.baseline.op_mix.get(op, 0.0)
                           - profile.op_mix.get(op, 0.0))
                       for op in sorted(ops))
        return max(worst, tv)

    def fired(self, profile: WorkloadProfile) -> bool:
        return self.drift(profile) >= self.threshold


class OnlineAutotuner:
    """Explore/exploit re-tuning hung off the engine's per-flush hook.

    Installed by ``Device.autotune(online=True)`` as ``engine.autotuner``;
    the engine calls :meth:`on_flush` at the end of every staged
    dispatch (sync or async worker thread — the hook is reentrancy- and
    thread-guarded). Every ``window_flushes`` flushes it takes a counter
    delta (``CounterBank.delta``), profiles it, and re-tunes when the
    drift detector fires (**exploit** the detected regime change
    immediately) or on every ``explore_every``-th window regardless
    (**explore**: the incumbent plan may have gone stale without any
    single feature drifting past threshold).

    Live application is restricted to what is safe mid-stream: the
    auto-flush bounds and lookahead always apply; the backend/layout
    switch waits for a window where no recorded graphs are pending (a
    layout flip under a half-recorded graph would split one program
    across lane formats).
    """

    def __init__(self, device, tuner: Tuner | None = None,
                 window_flushes: int = 16, explore_every: int = 8,
                 drift_threshold: float = 0.5):
        if window_flushes < 1 or explore_every < 1:
            raise ValueError("window_flushes and explore_every must be "
                             ">= 1")
        self.device = device
        self.tuner = tuner or Tuner(drift_threshold=drift_threshold)
        self.window_flushes = window_flushes
        self.explore_every = explore_every
        self.plan: TunedPlan | None = None
        self.windows = 0
        self.retunes = 0
        self._flushes = 0
        self._mark = device.engine.counters.snapshot()
        self._lock = threading.Lock()
        self._busy = False

    def on_flush(self, engine) -> None:
        """The engine's per-flush decision point. Cheap until a window
        boundary; never raises into the flush path."""
        with self._lock:
            if self._busy:
                return  # a re-tune's own flushes don't recurse
            self._flushes += 1
            if self._flushes < self.window_flushes:
                return
            self._flushes = 0
            delta = engine.counters.delta(self._mark)
            self._mark = engine.counters.snapshot()
            self._busy = True
        try:
            self._window_closed(delta)
        finally:
            self._busy = False

    def _window_closed(self, delta) -> None:
        cfg = self.device.config
        try:
            prof = WorkloadProfile.from_counters(
                delta, width=cfg.width,
                word_bits=cfg.resolved_layout().word_bits)
        except ValueError:
            return  # window carried no recorded ops (tracer detached)
        self.windows += 1
        if self.plan is not None \
                and not self.tuner.should_retune(self.plan, prof) \
                and self.windows % self.explore_every != 0:
            return
        plan = self.tuner.tune(prof, cfg)
        self.retunes += 1
        self.plan = plan
        if plan.non_default(cfg):
            self.device._apply_plan(plan, flush=False)
