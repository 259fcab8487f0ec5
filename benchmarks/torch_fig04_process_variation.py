"""Fig 4 through the PyTorch port: Monte-Carlo process-variation analysis
of MAJ3 (the paper's SPICE study): (a) success rate per input pattern vs
variation, (b) bitline deviation distribution vs variation (4-row
activation, MAJ3(1,1,0)).

The counterpart of ``benchmarks/fig04_process_variation.py``: the same
rows and ``derived`` format from ``repro_torch.core.analog`` on
``device``, whose bitline deviation is the charge-sharing kernel on a
CUDA card. The reference draws every call from one PRNG key, so the mixed
and the all-ones pattern (and the single-row activation) sit on the same
bitlines; :class:`FreshDraws` keeps that by seeding a fresh generator for
each call."""

from __future__ import annotations

from benchmarks.common import Row, row, timed_us
from repro_torch.core import analog
from repro_torch.core.profiles import MFR_H

SEED = 4


class FreshDraws:
    """``repro_torch.core.analog``'s Monte-Carlo functions, each call
    drawing from a new generator seeded with ``seed`` on ``device``:
    ``FreshDraws(4, "cpu").deviation_distribution(MFR_H, ...)`` is
    ``analog.deviation_distribution(analog.seeded_generator(4, "cpu"),
    MFR_H, ...)``."""

    def __init__(self, seed: int, device):
        self.seed = seed
        self.device = device

    def __getattr__(self, name: str):
        fn = getattr(analog, name)

        def call(*args, **kw):
            return fn(analog.seeded_generator(self.seed, self.device),
                      *args, **kw)
        return call


def run(device="cuda", seed: int = 0, model=None) -> list[Row]:
    """``model``: the analog functions without their generator argument
    (default ``FreshDraws(SEED + seed, device)``)."""
    if model is None:
        model = FreshDraws(SEED + seed, device)
    rows: list[Row] = []

    def patterns():
        out = {}
        for pv in (0.1, 0.2, 0.3, 0.4):
            # all-same patterns are always safe; mixed patterns degrade.
            dv_mixed = model.deviation_distribution(
                MFR_H, m_inputs=3, copies=1, n_neutral=1, ones=2,
                process_variation=pv)
            dv_same = model.deviation_distribution(
                MFR_H, m_inputs=3, copies=1, n_neutral=1, ones=3,
                process_variation=pv)
            # population sd, as jnp.std
            out[pv] = (float(dv_mixed.mean()),
                       float(dv_mixed.std(correction=0)),
                       float(dv_same.mean()))
        return out

    us, res = timed_us(patterns, repeat=1)
    for pv, (mu, sd, mu_same) in res.items():
        rows.append(row(f"fig04.deviation_pv{int(pv*100)}", us / 4,
                        f"maj3(1,1,0) dV={mu*1e3:.1f}mV sd={sd*1e3:.2f}mV "
                        f"all-ones dV={mu_same*1e3:.1f}mV"))
    # Deviation drop vs single-row activation (paper: -41.14%).
    dv1 = model.single_row_deviation(MFR_H, process_variation=0.2)
    dv3 = model.deviation_distribution(MFR_H, m_inputs=3, copies=1,
                                       n_neutral=1, ones=2,
                                       process_variation=0.2)
    drop = 1 - float(dv3.mean() / dv1.mean())
    rows.append(row("fig04.deviation_drop_vs_single", us,
                    f"sim={drop:.3f} paper=0.411"))
    return rows
