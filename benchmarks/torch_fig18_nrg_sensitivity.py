"""Fig 18 through the PyTorch port: sensitivity of MAJM performance to
N_RG under the four scenarios: RealExp (empirical SR + init latency),
RealInit (SR=1, real init), RealSR (real SR, no init), Ideal (SR=1, no
init) — normalized to FracDRAM.

The counterpart of ``benchmarks/fig18_nrg_sensitivity.py``: latencies
from the port's ``CostModel``, success rates from ``MonteCarloDb`` on
``device`` at the reference's sizes."""

from __future__ import annotations

from benchmarks.common import Row, row, timed_us
from repro_torch.core.charact import MonteCarloDb
from repro_torch.core.cost_model import CostModel
from repro_torch.core.profiles import PROFILES


def scenario_latency(cm: CostModel, m: int, n: int, frac_supported: bool,
                     init: bool) -> float:
    full = cm.maj_op(m, n, frac_supported=frac_supported)
    if init:
        return full.latency_ns
    # no-init scenario: only the APA + copy-out remain.
    return (cm.apa() + cm.aap()).latency_ns


def run(device="cuda", seed: int = 0, db=None) -> list[Row]:
    if db is None:
        db = MonteCarloDb(n_bitlines=512, n_groups=4,
                          n_patterns=24, seed=seed, device=device)
    cm = CostModel()
    rows: list[Row] = []
    for mfr, m in (("M", 5), ("M", 7), ("H", 5), ("H", 7), ("H", 9)):
        prof = PROFILES[mfr]
        if m > prof.max_maj_fan_in:
            continue
        base = (cm.maj_op(3, 4, frac_supported=prof.frac_supported)
                .latency_ns / max(db.mean(mfr, 3, 4), 1e-3))

        def scen():
            out = {}
            n = 8
            while n <= prof.max_simul_rows:
                if n >= m:
                    sr = max(db.mean(mfr, m, n), 1e-3)
                    work = (m + 1) // 2  # AND fan-in work per op vs MAJ3's 2
                    for name, (use_sr, use_init) in {
                            "RealExp": (True, True), "RealInit": (False, True),
                            "RealSR": (True, False), "Ideal": (False, False),
                    }.items():
                        lat = scenario_latency(cm, m, n,
                                               prof.frac_supported, use_init)
                        eff = lat / (sr if use_sr else 1.0) / (work / 2)
                        out.setdefault(name, {})[n] = base / eff
                n <<= 1
            return out

        us, out = timed_us(scen, repeat=1)
        for name, per_n in out.items():
            desc = " ".join(f"N{n}:{v:.2f}x" for n, v in per_n.items())
            rows.append(row(f"fig18.maj{m}_{mfr}_{name}", us / 4, desc))
    return rows
