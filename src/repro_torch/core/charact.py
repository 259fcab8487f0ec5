"""Characterization harness (paper §6.1.1, Figs 14-16, Table 1).

Success rates of MAJ-M at N_RG come from two databases:

* :class:`MonteCarloDb` — the port's copy of the reference's
  ``SuccessRateDb``: runs the analog Monte-Carlo model
  (``core/analog.py``, whose bitline deviation is the charge-sharing
  kernel on a CUDA device) across (manufacturer, MAJ-M, N_RG) and
  aggregates per-row-group success rates the way the paper does, with the
  systematic spatial variation across subarrays (Fig 16) on top of the
  random per-cell variation. Its draws are ``torch.Generator`` streams, so
  its rates agree with the reference's statistically, not bit for bit.
* :class:`SuccessRateDb` — the reference's ``default_db()`` points as a
  checked-in table (``success_points.json``, regenerated by
  ``python tests/test_torch_cost_plane.py --regen``): every point the
  engine's per-op configuration search can ask for
  (:func:`query_points`). :func:`default_db` and the engine keep this
  table, so the cost plane charges exactly the floats the reference
  charges. Any other point raises and names :class:`MonteCarloDb`.
"""

from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import zlib
from functools import lru_cache

import numpy as np

from repro_torch.core import analog
from repro_torch.core.profiles import PROFILES
from repro_torch.core.replication import plan as replication_plan, plan_pow2

TABLE_PATH = pathlib.Path(__file__).with_name("success_points.json")

_NOT_TABULATED = ("the checked-in table holds only the engine's query "
                  "points; MonteCarloDb (the analog Monte-Carlo model) "
                  "computes any point")


def spatial_pv_multiplier(subarray: int, n_subarrays: int) -> float:
    """Systematic process-variation modulation across a bank.

    Fig 16 reports an M-shaped success-rate profile (peaks in the 1st and
    3rd quarters). Success falls when variation rises, so sigma_pv is
    modulated with a W-shaped (inverted-M) profile: minima at x=0.25 and
    x=0.75, mapped to a [0.9, 1.25] multiplier.
    """
    x = (subarray + 0.5) / n_subarrays
    return 1.075 + 0.175 * math.cos(4 * math.pi * x)


@dataclasses.dataclass(frozen=True)
class SuccessPoint:
    mfr: str
    m_inputs: int
    n_rg: int
    mean: float
    q1: float
    q3: float
    lo: float
    hi: float


def query_points(mfr: str) -> list[tuple[int, int, str]]:
    """Every ``(m_inputs, n_rg, plan_style)`` the engine's per-op
    configuration search (``PulsarEngine._cfg_for``) can query for ``mfr``:
    odd MAJ-m up to the profile's fan-in cap on power-of-two N_RG up to
    its row cap (``pow2`` plans), plus the FracDRAM baseline MAJ3 at N=4
    (``max`` plan) where the chip can activate four rows."""
    prof = PROFILES[mfr]
    cap = prof.max_simul_rows
    pows = [n for n in (4, 8, 16, 32) if n <= cap]
    out = []
    m = 3
    while m <= min(prof.max_maj_fan_in, cap):
        out.extend((m, n, "pow2") for n in pows if n >= m)
        m += 2
    if cap >= 4:
        out.append((3, 4, "max"))
    return out


def figure_points(mfr: str) -> list[tuple[int, int, str]]:
    """Every ``(m_inputs, n_rg, plan_style)`` the paper's figures and
    claims query for ``mfr`` (``max`` plans, as ``SuccessRateDb.point``
    defaults): MAJ3 against N_RG (Fig 14, ``tests/test_system.py``'s
    headline claim) and MAJ-m up to the profile's fan-in cap against
    power-of-two N_RG (Fig 15)."""
    prof = PROFILES[mfr]
    out = []
    for m in (3, 5, 7, 9):
        if m > prof.max_maj_fan_in:
            continue
        out.extend((m, n, "max") for n in (4, 8, 16, 32)
                   if m <= n <= prof.max_simul_rows)
    return out


def table_points(mfr: str) -> list[tuple[int, int, str]]:
    """The points the checked-in table holds for ``mfr``: the engine's
    planning queries, then the figures' (each once)."""
    pts = query_points(mfr)
    return pts + [p for p in figure_points(mfr) if p not in pts]


class SuccessRateDb:
    """Success points keyed on ``(mfr, m_inputs, n_rg, plan_style)``.

    ``points`` is an iterable of dicts with the :class:`SuccessPoint`
    fields plus ``plan_style`` (the table's row format)."""

    def __init__(self, points):
        self._points: dict[tuple, SuccessPoint] = {}
        for p in points:
            p = dict(p)
            style = p.pop("plan_style")
            sp = SuccessPoint(**p)
            self._points[(sp.mfr, sp.m_inputs, sp.n_rg, style)] = sp

    def point(self, mfr: str, m_inputs: int, n_rg: int,
              subarray_frac: float | None = None,
              plan_style: str = "max") -> SuccessPoint:
        profile = PROFILES[mfr]
        if n_rg > profile.max_simul_rows:
            raise ValueError(f"Mfr {mfr} caps at {profile.max_simul_rows} rows")
        if subarray_frac is not None:
            raise NotImplementedError(
                f"no tabulated per-subarray success rates: "
                f"{_NOT_TABULATED}")
        sp = self._points.get((mfr, m_inputs, n_rg, plan_style))
        if sp is None:
            raise NotImplementedError(
                f"no tabulated success rate for mfr={mfr!r} MAJ{m_inputs} "
                f"at N_RG={n_rg} ({plan_style} plan): {_NOT_TABULATED}")
        return sp

    def mean(self, mfr: str, m_inputs: int, n_rg: int,
             plan_style: str = "max") -> float:
        return self.point(mfr, m_inputs, n_rg, plan_style=plan_style).mean


class MonteCarloDb:
    """Monte-Carlo success rates (the reference's ``SuccessRateDb``),
    computed on ``device`` and cached per point.

    Each point runs ``n_groups`` row groups of ``n_bitlines`` bitlines
    under ``n_patterns`` random input patterns; group ``g`` draws from a
    generator seeded with the reference's integer for its PRNG key
    (``seed * 7919 + crc32(repr(key)) % 2**31 + g``). Same arguments on
    the same device type => the same rates.
    """

    def __init__(self, n_bitlines: int = 2048, n_groups: int = 24,
                 n_patterns: int = 48, seed: int = 0, device="cuda"):
        self.n_bitlines = n_bitlines
        self.n_groups = n_groups
        self.n_patterns = n_patterns
        self.seed = seed
        self.device = device
        self._cache: dict[tuple, SuccessPoint] = {}

    def point(self, mfr: str, m_inputs: int, n_rg: int,
              subarray_frac: float | None = None,
              plan_style: str = "max") -> SuccessPoint:
        key = (mfr, m_inputs, n_rg,
               None if subarray_frac is None else round(subarray_frac, 3),
               plan_style)
        if key in self._cache:
            return self._cache[key]
        profile = PROFILES[mfr]
        if n_rg > profile.max_simul_rows:
            raise ValueError(f"Mfr {mfr} caps at {profile.max_simul_rows} rows")
        rp = (plan_pow2 if plan_style == "pow2" else replication_plan)(
            m_inputs, n_rg)
        pv_mult = (spatial_pv_multiplier(int(subarray_frac * 16), 16)
                   if subarray_frac is not None else 1.0)
        # Stable (non-salted) per-key hash for reproducible streams.
        key_hash = zlib.crc32(repr(key).encode())
        rates = []
        for g in range(self.n_groups):
            gen = analog.seeded_generator(
                self.seed * 7919 + key_hash % (2**31) + g, self.device)
            rate, _ = analog.maj_success_rate(
                gen, profile, m_inputs=m_inputs, copies=rp.copies,
                n_neutral=rp.n_neutral, n_bitlines=self.n_bitlines,
                n_patterns=self.n_patterns,
                process_variation=profile.process_variation * pv_mult)
            rates.append(rate)
        arr = np.array(rates)
        sp = SuccessPoint(mfr, m_inputs, n_rg, float(arr.mean()),
                          float(np.quantile(arr, 0.25)),
                          float(np.quantile(arr, 0.75)),
                          float(arr.min()), float(arr.max()))
        self._cache[key] = sp
        return sp

    def mean(self, mfr: str, m_inputs: int, n_rg: int,
             plan_style: str = "max") -> float:
        return self.point(mfr, m_inputs, n_rg, plan_style=plan_style).mean

    def fig14_maj3_vs_n(self, mfr: str) -> dict[int, SuccessPoint]:
        """MAJ3 success vs N_RG (Fig 14)."""
        prof = PROFILES[mfr]
        return {n: self.point(mfr, 3, n) for n in (4, 8, 16, 32)
                if n <= prof.max_simul_rows}

    def fig15_majm(self, mfr: str) -> dict[tuple[int, int], SuccessPoint]:
        """MAJ3/5/7/9 success vs N_RG (Fig 15)."""
        prof = PROFILES[mfr]
        return {(m, n): self.point(mfr, m, n)
                for m in (3, 5, 7, 9) for n in (4, 8, 16, 32)
                if m <= n <= prof.max_simul_rows}

    def fig16_spatial(self, mfr: str = "H", n_subarrays: int = 16,
                      n_rg: int = 32) -> list[tuple[int, float, float]]:
        """Per-subarray MAJ3 success for PULSAR vs FracDRAM (Fig 16).
        Returns [(subarray, pulsar_rate, fracdram_rate)]."""
        prof = PROFILES[mfr]
        n_rg = min(n_rg, prof.max_simul_rows)
        rows = []
        for sa in range(n_subarrays):
            frac = (sa + 0.5) / n_subarrays
            p = self.point(mfr, 3, n_rg, subarray_frac=frac)
            f = self.point(mfr, 3, 4, subarray_frac=frac)
            rows.append((sa, p.mean, f.mean))
        return rows

    def best_n_rg(self, mfr: str, m_inputs: int,
                  latency_fn) -> tuple[int, float]:
        """Pick the N_RG maximizing throughput = SR / latency(M, N) — the
        paper's per-op configuration search (§6.1.2)."""
        prof = PROFILES[mfr]
        best, best_t = None, -1.0
        n = 4
        while n <= prof.max_simul_rows:
            if n >= m_inputs:
                thr = self.mean(mfr, m_inputs, n) / latency_fn(m_inputs, n)
                if thr > best_t:
                    best, best_t = n, thr
            n <<= 1
        if best is None:
            raise ValueError(f"MAJ{m_inputs} unsupported on Mfr {mfr}")
        return best, best_t


def load_points(path=TABLE_PATH) -> list[dict]:
    with open(path, encoding="utf-8") as f:
        return json.load(f)["points"]


@lru_cache(maxsize=1)
def default_db() -> SuccessRateDb:
    """The reference's ``default_db()`` (seed 0) as a table."""
    return SuccessRateDb(load_points())
