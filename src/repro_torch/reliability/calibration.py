"""Chip calibration: profile a (simulated) PULSAR chip into a ReliabilityMap.

The port's copy of ``repro.reliability.calibration``. ``calibrate()`` runs
the analog Monte-Carlo model (``core/analog.py``, whose bitline deviation
is the charge-sharing kernel on a CUDA device) over every (bank, subarray,
replication config) of a simulated chip and keeps the result as a
:class:`ReliabilityMap`:

* ``success[b, s, c]`` — fraction of stable columns for config ``c`` in
  subarray ``s`` of bank ``b`` (the paper's per-row-group success rate);
* ``flip_p[b, s, c, col]`` — per-trial flip probability of each column,
  used by the fault injector and by weak-column steering.

Spatial structure: the W-shaped process-variation profile of
``charact.spatial_pv_multiplier`` across subarrays, plus a seeded per-bank
lot multiplier drawn exactly as the reference draws it
(``np.random.default_rng([seed, crc32(mfr)])``). Each (bank, subarray,
config) draws from a ``torch.Generator`` seeded with the reference's
integer for its PRNG key (the ``zlib.crc32`` fold of :func:`stable_seed`).

``jax.random`` cannot be reproduced in torch, and CPU and CUDA generators
differ from each other: a map is bit-identical for the same arguments on
the same device type, and agrees with the reference's map statistically.
The exact bridge is ``convert.reliability_map_from_reference``. Maps save
and load in the reference's ``.npz`` + JSON-meta format, byte-compatible
both ways.
"""

from __future__ import annotations

import json
import math
import os
import zlib

import numpy as np
import torch

from repro_torch.core import analog
from repro_torch.core.charact import spatial_pv_multiplier
from repro_torch.core.profiles import PROFILES
from repro_torch.core.replication import ReplicationPlan, plan as replication_plan

# Per-trial flip probability at exactly the stability threshold
# (worst margin == TRIAL_TAIL_SIGMA * sigma): columns below this are the
# analog model's "stable" columns.
P_STABLE = 0.5 * math.erfc(analog.TRIAL_TAIL_SIGMA / math.sqrt(2.0))

# Replication configs profiled by default: (MAJ fan-in, N_RG). Filtered per
# manufacturer against max_simul_rows / max_maj_fan_in at calibrate() time.
DEFAULT_CONFIGS = ((3, 4), (3, 8), (3, 16), (3, 32),
                   (5, 8), (5, 16), (5, 32))


def stable_seed(seed: int, *parts) -> int:
    """Process-stable generator seed: the integer the reference turns into
    its PRNG key (crc32 of the repr, never the salted builtin hash)."""
    h = zlib.crc32(repr(parts).encode())
    return seed * 7919 + h % (2 ** 31)


class ReliabilityMap:
    """Persistent per-bank / per-subarray / per-column reliability profile.

    A plain class (not a dataclass): instances hash/compare by identity so
    a map can sit inside the frozen ``EngineConfig`` without dragging
    megabytes of arrays into equality checks.
    """

    def __init__(self, *, mfr: str, seed: int, n_subarrays: int,
                 n_columns: int, configs: tuple[tuple[int, int], ...],
                 success: np.ndarray, flip_p: np.ndarray,
                 bank_scale: np.ndarray):
        self.mfr = mfr
        self.seed = seed
        self.n_subarrays = n_subarrays
        self.n_columns = n_columns
        self.configs = tuple((int(m), int(n)) for m, n in configs)
        self.success = np.asarray(success, np.float64)
        self.flip_p = np.asarray(flip_p, np.float32)
        self.bank_scale = np.asarray(bank_scale, np.float64)
        expect = (self.n_banks, n_subarrays, len(self.configs), n_columns)
        if self.flip_p.shape != expect:
            raise ValueError(f"flip_p shape {self.flip_p.shape} != {expect}")

    @property
    def n_banks(self) -> int:
        return self.success.shape[0]

    def __repr__(self) -> str:
        return (f"ReliabilityMap(mfr={self.mfr!r}, banks={self.n_banks}, "
                f"subarrays={self.n_subarrays}, columns={self.n_columns}, "
                f"configs={self.configs}, seed={self.seed})")

    # ------------------------------------------------------------------ #
    # Queries

    def config_index(self, m_inputs: int, n_rg: int) -> int | None:
        try:
            return self.configs.index((m_inputs, n_rg))
        except ValueError:
            return None

    def nearest_config(self, m_inputs: int, n_rg: int) -> int:
        """Closest profiled config: same fan-in preferred, then nearest N_RG
        (ties toward the larger, i.e. more-replicated, config)."""
        scored = sorted(
            (abs(m - m_inputs), abs(n - n_rg), -n, i)
            for i, (m, n) in enumerate(self.configs))
        return scored[0][3]

    def escalated_config(self, cfg_idx: int, level: int) -> int:
        """Config after ``level`` escalation steps: same fan-in, next larger
        N_RG per step (more input replication copies — Fig 11's reliability
        lever). Saturates at the largest profiled N_RG for that fan-in."""
        m, _ = self.configs[cfg_idx]
        ladder = sorted((i for i, (mi, _) in enumerate(self.configs)
                         if mi == m), key=lambda i: self.configs[i][1])
        pos = ladder.index(cfg_idx)
        return ladder[min(pos + level, len(ladder) - 1)]

    def mean_success(self, m_inputs: int, n_rg: int) -> float | None:
        """Chip-wide mean success for a config, or None if not profiled."""
        i = self.config_index(m_inputs, n_rg)
        if i is None:
            return None
        return float(self.success[:, :, i].mean())

    def home_order(self, cfg_idx: int) -> list[tuple[int, int]]:
        """(bank, subarray) placement homes ranked best-first for a config —
        the steering order for variation-aware scheduling."""
        sr = self.success[:, :, cfg_idx]
        flat = [(float(sr[b, s]), b, s)
                for b in range(self.n_banks)
                for s in range(self.n_subarrays)]
        flat.sort(key=lambda t: (-t[0], t[1], t[2]))
        return [(b, s) for _, b, s in flat]

    def bank_order(self) -> list[int]:
        """Banks ranked by mean success over all subarrays/configs (for a
        controller's batch schedule)."""
        means = self.success.mean(axis=(1, 2))
        return sorted(range(self.n_banks), key=lambda b: (-means[b], b))

    def column_flip_p(self, bank: int, subarray: int,
                      cfg_idx: int) -> np.ndarray:
        return self.flip_p[bank, subarray, cfg_idx]

    def weak_column_frac(self, cfg_idx: int,
                         threshold: float | None = None) -> float:
        """Fraction of columns chip-wide whose flip probability exceeds the
        stability threshold for a config."""
        t = P_STABLE if threshold is None else threshold
        return float((self.flip_p[:, :, cfg_idx] > t).mean())

    def best_plan(self, m_inputs: int, target_success: float
                  ) -> tuple[ReplicationPlan, float]:
        """Cheapest profiled config of fan-in ``m_inputs`` whose chip-wide
        success meets ``target_success`` (fewest rows = fastest ACT chain);
        falls back to the most reliable profiled config when none does.
        Returns (fig-10 replication plan, expected success)."""
        cands = [(n, self.mean_success(m_inputs, n))
                 for m, n in self.configs if m == m_inputs]
        if not cands:
            raise ValueError(f"MAJ{m_inputs} not profiled in this map")
        ok = [(n, s) for n, s in cands if s >= target_success]
        if ok:
            n, s = min(ok, key=lambda t: t[0])
        else:
            n, s = max(cands, key=lambda t: t[1])
        return replication_plan(m_inputs, n), s

    # ------------------------------------------------------------------ #
    # Persistence (the reference's format)

    def save(self, path: str | os.PathLike) -> None:
        """Persist as a single .npz (arrays + JSON-encoded metadata)."""
        meta = json.dumps({
            "mfr": self.mfr, "seed": self.seed,
            "n_subarrays": self.n_subarrays, "n_columns": self.n_columns,
            "configs": [list(c) for c in self.configs],
        })
        np.savez_compressed(
            path, success=self.success, flip_p=self.flip_p,
            bank_scale=self.bank_scale,
            meta=np.frombuffer(meta.encode(), dtype=np.uint8))

    @classmethod
    def load(cls, path: str | os.PathLike) -> "ReliabilityMap":
        with np.load(path) as z:
            meta = json.loads(bytes(z["meta"]).decode())
            return cls(
                mfr=meta["mfr"], seed=meta["seed"],
                n_subarrays=meta["n_subarrays"],
                n_columns=meta["n_columns"],
                configs=tuple(tuple(c) for c in meta["configs"]),
                success=z["success"], flip_p=z["flip_p"],
                bank_scale=z["bank_scale"])


def calibrate(mfr: str = "M", *, banks: int = 16, n_subarrays: int = 8,
              n_columns: int = 512, n_patterns: int = 12,
              configs: tuple[tuple[int, int], ...] | None = None,
              seed: int = 0, process_variation: float | None = None,
              bank_sigma: float = 0.06, device="cuda") -> ReliabilityMap:
    """Profile a simulated chip into a :class:`ReliabilityMap`.

    One Monte-Carlo characterization per (bank, subarray, config), run on
    ``device`` (default ``"cuda"``: the charge-sharing kernel): seeded
    static draws (cell caps + sense offsets) under the subarray's W-shaped
    process-variation multiplier and a per-bank lot multiplier, reduced to
    per-column flip probabilities. The map's arrays are NumPy. Same
    arguments on the same device type => bit-identical map.

    ``process_variation`` overrides the profile's nominal sigma;
    ``bank_sigma`` is the relative spread of the per-bank multiplier.
    """
    profile = PROFILES[mfr]
    if configs is None:
        configs = DEFAULT_CONFIGS
    configs = tuple(
        (m, n) for m, n in configs
        if n <= profile.max_simul_rows and m <= profile.max_maj_fan_in
        and n >= m)
    if not configs:
        raise ValueError(f"no profiled configs fit manufacturer {mfr!r}")
    pv0 = (profile.process_variation if process_variation is None
           else float(process_variation))
    # Per-bank lot variation: seeded, process-stable (PCG64 stream).
    rng = np.random.default_rng([seed, zlib.crc32(mfr.encode())])
    bank_scale = np.clip(1.0 + bank_sigma * rng.standard_normal(banks),
                         0.5, 2.0)

    gen = analog.seeded_generator(0, device)
    rates = torch.empty((banks, n_subarrays, len(configs)),
                        dtype=torch.float32, device=gen.device)
    flip_p = torch.empty((banks, n_subarrays, len(configs), n_columns),
                         dtype=torch.float32, device=gen.device)
    for b in range(banks):
        for s in range(n_subarrays):
            pv = pv0 * spatial_pv_multiplier(s, n_subarrays) * bank_scale[b]
            for c, (m, n) in enumerate(configs):
                rp = replication_plan(m, n)  # paper plan: maximal copies
                gen.manual_seed(stable_seed(seed, mfr, b, s, m, n))
                sample, patterns = analog.draw_margin_inputs(
                    gen, profile, m_inputs=m, copies=rp.copies,
                    n_neutral=rp.n_neutral, n_bitlines=n_columns,
                    n_patterns=n_patterns, process_variation=pv)
                worst, sigma = analog.worst_margins_from_draws(
                    profile, sample, patterns, copies=rp.copies,
                    n_neutral=rp.n_neutral)
                stable, flip = analog.stable_and_flip(worst, sigma)
                rates[b, s, c] = stable.to(torch.float32).mean()
                flip_p[b, s, c] = flip
    return ReliabilityMap(mfr=mfr, seed=seed, n_subarrays=n_subarrays,
                          n_columns=n_columns, configs=configs,
                          success=rates.cpu().numpy().astype(np.float64),
                          flip_p=flip_p.cpu().numpy(),
                          bank_scale=bank_scale)
