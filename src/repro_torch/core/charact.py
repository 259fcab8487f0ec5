"""Success rates of MAJ-M at N_RG, served from a checked-in table.

The reference draws these rates from an analog Monte-Carlo model over
``jax.random`` streams, which torch cannot reproduce bit for bit. The port
ships the reference's ``default_db()`` points instead
(``success_points.json``, regenerated by
``python tests/test_torch_cost_plane.py --regen``): every point the engine's
per-op configuration search can ask for (:func:`query_points`), so the cost
plane charges exactly the floats the reference charges. Any other point
raises; the Monte-Carlo model itself comes with the analog slice (kernel
``charge_share``).
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from functools import lru_cache

from repro_torch.core.profiles import PROFILES

TABLE_PATH = pathlib.Path(__file__).with_name("success_points.json")

_ANALOG_SLICE = ("the analog Monte-Carlo slice (core/analog.py and the "
                 "charge_share kernel) is not ported yet")


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
                f"per-subarray success rates need the Monte-Carlo model: "
                f"{_ANALOG_SLICE}")
        sp = self._points.get((mfr, m_inputs, n_rg, plan_style))
        if sp is None:
            raise NotImplementedError(
                f"no tabulated success rate for mfr={mfr!r} MAJ{m_inputs} "
                f"at N_RG={n_rg} ({plan_style} plan): {_ANALOG_SLICE}")
        return sp

    def mean(self, mfr: str, m_inputs: int, n_rg: int,
             plan_style: str = "max") -> float:
        return self.point(mfr, m_inputs, n_rg, plan_style=plan_style).mean


def load_points(path=TABLE_PATH) -> list[dict]:
    with open(path, encoding="utf-8") as f:
        return json.load(f)["points"]


@lru_cache(maxsize=1)
def default_db() -> SuccessRateDb:
    """The reference's ``default_db()`` (seed 0) as a table."""
    return SuccessRateDb(load_points())
