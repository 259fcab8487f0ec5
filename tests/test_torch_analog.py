"""The port's analog Monte-Carlo against the reference.

Two kinds of hold:

* **Exact, through the draw-free core.** The reference's own
  ``jax.random`` draws (bitlines and patterns, split exactly as
  ``repro.core.analog._worst_margins`` splits its key) are fed to
  ``worst_margins_from_draws`` / ``column_profile_from_draws``; the result
  must reproduce ``column_flip_probs``: worst margins within 5e-7 V (the
  row sums run in another order: a few float32 ulps of the ~0.1 V
  margins; measured at most 7.5e-8 V), flip probabilities within rtol
  1e-3 (float32 erfc implementations differ by a few ulps, amplified by
  the Gaussian tail's slope; measured at most 1.3e-4), and stable masks
  equal off the tie band ``|worst - 3.9 sigma| <= 1e-6 V`` (ten times the
  worst-margin error: a column inside it may resolve either way).
* **Statistical, through the port's own draws.** ``torch.Generator``
  streams are not ``jax.random``'s, so ``MonteCarloDb`` and
  ``calibrate()`` are held to the paper's anchors and to the reference's
  rates within stated Monte-Carlo bounds.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import analog as ranalog
from repro.core.charact import spatial_pv_multiplier as r_spatial
from repro.core.profiles import PROFILES as RPROFILES
from repro.reliability import calibrate as r_calibrate
from repro_torch.core import analog
from repro_torch.core.charact import MonteCarloDb, spatial_pv_multiplier
from repro_torch.core.cost_model import CostModel
from repro_torch.core.profiles import MFR_H, PROFILES
from repro_torch.core.replication import plan
from repro_torch.kernels import ops
from repro_torch.reliability import calibrate

WORST_ATOL = 5e-7   # volts
FLIP_RTOL = 1e-3
TIE_BAND = 1e-6     # volts


def gen(seed: int = 0) -> torch.Generator:
    return analog.seeded_generator(seed, "cpu")


def reference_draws(key, mfr, m, copies, n_neutral, n_bitlines, n_patterns,
                    pv):
    """The draws ``repro.core.analog._worst_margins`` makes from ``key``,
    as the port's tensors."""
    kd, kp, _ = jax.random.split(key, 3)
    n_rows = m * copies + n_neutral
    s = ranalog.draw_bitlines(kd, RPROFILES[mfr], n_rows, n_bitlines, pv)
    pat = jax.random.bernoulli(kp, 0.5, (n_patterns, m, n_bitlines))
    sample = analog.BitlineSample(
        cell_caps=torch.tensor(np.asarray(s.cell_caps)),
        sense_offset=torch.tensor(np.asarray(s.sense_offset)))
    return sample, torch.tensor(np.asarray(pat, np.float32))


@pytest.mark.parametrize("mfr,m,n,pv", [
    ("H", 3, 4, None), ("H", 3, 32, None), ("H", 5, 32, 0.3),
    ("M", 3, 4, 0.4), ("M", 5, 16, 0.4), ("M", 3, 16, None)])
def test_core_reproduces_column_flip_probs(mfr, m, n, pv):
    rp = plan(m, n)
    key = jax.random.PRNGKey(7 * n + m)
    kw = dict(m_inputs=m, copies=rp.copies, n_neutral=rp.n_neutral,
              n_bitlines=2048, n_patterns=12, process_variation=pv)
    worst_ref, sigma_ref = ranalog._worst_margins(key, RPROFILES[mfr], **kw)
    want = ranalog.column_flip_probs(key, RPROFILES[mfr], **kw)
    sample, pat = reference_draws(key, mfr, m, rp.copies, rp.n_neutral,
                                  2048, 12, pv)
    worst, sigma = analog.worst_margins_from_draws(
        PROFILES[mfr], sample, pat, copies=rp.copies, n_neutral=rp.n_neutral)
    assert float(sigma) == float(sigma_ref)  # float32, the same order
    worst_ref = np.asarray(worst_ref)
    np.testing.assert_allclose(worst.numpy(), worst_ref, rtol=0,
                               atol=WORST_ATOL)
    got = analog.column_profile_from_draws(PROFILES[mfr], sample, pat,
                                           copies=rp.copies,
                                           n_neutral=rp.n_neutral)
    np.testing.assert_allclose(got.flip_p, want.flip_p, rtol=FLIP_RTOL,
                               atol=1e-30)
    off_tie = np.abs(worst_ref - analog.TRIAL_TAIL_SIGMA * float(sigma)) \
        > TIE_BAND
    np.testing.assert_array_equal(got.stable[off_tie], want.stable[off_tie])
    tie = (~off_tie).sum()
    assert abs(got.rate - want.rate) <= tie / 2048


def test_bitline_deviation_matches_reference():
    rng = np.random.default_rng(4)
    cells = rng.integers(0, 2, (11, 900)).astype(np.float32)
    neutral = np.zeros(11, bool)
    neutral[-2:] = True
    caps = (20 * (1 + 0.2 * rng.standard_normal((11, 900)))).astype(
        np.float32)
    want = ranalog.bitline_deviation(jnp.asarray(cells), jnp.asarray(neutral),
                                     jnp.asarray(caps), vdd=MFR_H.vdd,
                                     c_bl=MFR_H.bitline_cap_ff)
    got = analog.bitline_deviation(torch.tensor(cells), torch.tensor(neutral),
                                   torch.tensor(caps), vdd=MFR_H.vdd,
                                   c_bl=MFR_H.bitline_cap_ff)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)


def test_trial_sigma_and_constants_match():
    for mfr in ("H", "M"):
        for n_rows in (4, 16, 32):
            _, s_ref = ranalog._worst_margins(
                jax.random.PRNGKey(0), RPROFILES[mfr], m_inputs=3, copies=1,
                n_neutral=n_rows - 3, n_bitlines=8, n_patterns=2,
                process_variation=None)
            assert float(analog.trial_sigma(PROFILES[mfr], n_rows)) == \
                float(s_ref)
    assert analog.TRIAL_TAIL_SIGMA == ranalog.TRIAL_TAIL_SIGMA
    for sa in range(16):
        assert spatial_pv_multiplier(sa, 16) == r_spatial(sa, 16)


def test_seeded_draws_repeat_on_one_device_type():
    kw = dict(m_inputs=3, copies=2, n_neutral=2, n_bitlines=256,
              n_patterns=8)
    a = analog.column_flip_probs(gen(5), MFR_H, **kw)
    b = analog.column_flip_probs(gen(5), MFR_H, **kw)
    np.testing.assert_array_equal(a.flip_p, b.flip_p)
    c = analog.column_flip_probs(gen(6), MFR_H, **kw)
    assert not np.array_equal(a.flip_p, c.flip_p)


def test_success_rate_matches_column_profile():
    kw = dict(m_inputs=5, copies=3, n_neutral=1, n_bitlines=512,
              n_patterns=16)
    rate, stable = analog.maj_success_rate(gen(3), MFR_H, **kw)
    prof = analog.column_flip_probs(gen(3), MFR_H, **kw)
    assert rate == prof.rate
    np.testing.assert_array_equal(stable.numpy(), prof.stable)


def test_deviation_runs_through_charge_share_dispatch():
    before = dict(ops.LAUNCHES)
    dv = analog.deviation_distribution(gen(), MFR_H, m_inputs=3, copies=1,
                                       n_neutral=1, ones=2)
    assert dv.shape == (4096,) and dv.dtype == torch.float32
    assert dict(ops.LAUNCHES) == before  # CPU tensors: the plain version


# --------------------------------------------------------------------- #
# The reference's analog anchors (tests/core/test_analog_calibration.py)
# on the port's own draws


def test_deviation_sign_follows_majority():
    dv1 = analog.deviation_distribution(gen(), MFR_H, m_inputs=3, copies=1,
                                        n_neutral=1, ones=2)
    dv0 = analog.deviation_distribution(gen(), MFR_H, m_inputs=3, copies=1,
                                        n_neutral=1, ones=1)
    assert float(dv1.mean()) > 0 > float(dv0.mean())


def test_replication_boosts_deviation_159pct():
    p32 = plan(3, 32)
    dv32 = analog.deviation_distribution(gen(), MFR_H, m_inputs=3,
                                         copies=p32.copies,
                                         n_neutral=p32.n_neutral, ones=2,
                                         process_variation=0.0)
    dv4 = analog.deviation_distribution(gen(), MFR_H, m_inputs=3, copies=1,
                                        n_neutral=1, ones=2,
                                        process_variation=0.0)
    boost = float(dv32.mean() / dv4.mean()) - 1.0
    assert 1.40 < boost < 1.80  # paper: 1.59


def test_maj3_deviation_below_single_row():
    dv_maj = analog.deviation_distribution(gen(), MFR_H, m_inputs=3,
                                           copies=1, n_neutral=1, ones=2,
                                           process_variation=0.0)
    dv_one = analog.single_row_deviation(gen(), MFR_H, process_variation=0.0)
    drop = 1.0 - float(dv_maj.mean() / dv_one.mean())
    assert 0.30 < drop < 0.55  # paper: 0.41


def test_variation_widens_distribution():
    kw = dict(m_inputs=3, copies=1, n_neutral=1, ones=2)
    lo = analog.deviation_distribution(gen(), MFR_H, process_variation=0.1,
                                       **kw)
    hi = analog.deviation_distribution(gen(), MFR_H, process_variation=0.4,
                                       **kw)
    assert float(hi.std()) > float(lo.std())


def test_success_trends():
    db = MonteCarloDb(n_bitlines=1024, n_groups=8, n_patterns=32,
                      device="cpu")
    curve = [db.mean("H", 3, n) for n in (4, 8, 16, 32)]
    assert curve == sorted(curve) and curve[-1] > curve[0] + 0.05
    assert db.mean("H", 3, 32) > db.mean("H", 5, 32) > db.mean("H", 7, 32)
    assert db.mean("M", 3, 16) > db.mean("H", 3, 16)


def test_calibration_anchors_at_reference_sizes():
    """The paper's headline numbers on the port's Monte-Carlo at the
    reference's default sizes (2048 bitlines, 24 groups, 48 patterns),
    with the reference test's bounds."""
    db = MonteCarloDb(device="cpu")
    frac = db.mean("H", 3, 4)
    pulsar = db.mean("H", 3, 32)
    maj5 = db.mean("H", 5, 32)
    assert 0.70 <= frac <= 0.88       # paper: 0.7885
    assert pulsar >= 0.93             # paper: 0.9791
    assert pulsar - frac > 0.10       # paper: +24.18 points
    assert 0.55 <= maj5 <= 0.92       # paper: 0.7393


def test_db_figures_and_best_n_rg():
    db = MonteCarloDb(n_bitlines=256, n_groups=3, n_patterns=12,
                      device="cpu")
    assert sorted(db.fig14_maj3_vs_n("M")) == [4, 8, 16]
    assert (5, 8) in db.fig15_majm("H") and (9, 4) not in db.fig15_majm("H")
    rows = db.fig16_spatial("M", n_subarrays=4, n_rg=32)
    assert [r[0] for r in rows] == [0, 1, 2, 3]
    assert all(0 <= r[1] <= 1 and 0 <= r[2] <= 1 for r in rows)
    cm = CostModel()
    n, thr = db.best_n_rg("H", 5, lambda m, nn: cm.maj_op(m, nn).latency_ns)
    assert n in (8, 16, 32) and thr > 0
    with pytest.raises(ValueError):
        db.point("M", 3, 32)  # Mfr M caps at 16 rows


# --------------------------------------------------------------------- #
# calibrate(): the port's map against the reference's, statistically


def test_calibrate_success_within_monte_carlo_bound():
    """Per-config chip-wide success of the port's map against the
    reference's at the same arguments. Each is a mean over banks x
    subarrays x n_columns = 4096 columns; the bound is 5 standard
    deviations of the difference of two independent binomial means,
    ``5 * sqrt(2 p (1 - p) / 4096)`` (the bank multipliers are the same
    NumPy draws in both, so only the column draws differ)."""
    kw = dict(banks=2, n_subarrays=4, n_columns=512, n_patterns=8, seed=3)
    want = r_calibrate("M", **kw)
    got = calibrate("M", device="cpu", **kw)
    assert got.configs == want.configs
    np.testing.assert_array_equal(got.bank_scale, want.bank_scale)
    n_cols = 2 * 4 * 512
    for c in range(len(got.configs)):
        p = want.success[:, :, c].mean()
        bound = 5 * math.sqrt(2 * max(p * (1 - p), 1 / n_cols) / n_cols)
        assert abs(got.success[:, :, c].mean() - p) <= bound, got.configs[c]
