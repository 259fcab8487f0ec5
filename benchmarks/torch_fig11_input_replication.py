"""Fig 11 through the PyTorch port: effect of input replication on
bitline deviation (a) and MAJ3 success (b) for N in {4,8,16,32} across
process-variation levels.

The counterpart of ``benchmarks/fig11_input_replication.py``: the same
rows and ``derived`` format from ``repro_torch.core.analog`` on
``device`` (the charge-sharing kernel on a CUDA card), each call drawing
from a fresh generator as the reference reuses one PRNG key."""

from __future__ import annotations

from benchmarks.common import Row, row, timed_us
from benchmarks.torch_fig04_process_variation import FreshDraws
from repro_torch.core.profiles import MFR_H
from repro_torch.core.replication import plan

SEED = 11


def run(device="cuda", seed: int = 0, model=None) -> list[Row]:
    """``model``: the analog functions without their generator argument
    (default ``FreshDraws(SEED + seed, device)``)."""
    if model is None:
        model = FreshDraws(SEED + seed, device)
    rows: list[Row] = []
    base = None
    for n in (4, 8, 16, 32):
        rp = plan(3, n)

        def point():
            dv = model.deviation_distribution(
                MFR_H, m_inputs=3, copies=rp.copies,
                n_neutral=rp.n_neutral, ones=2, process_variation=0.2)
            sr, _ = model.maj_success_rate(
                MFR_H, m_inputs=3, copies=rp.copies,
                n_neutral=rp.n_neutral, n_bitlines=2048, n_patterns=32)
            return float(dv.mean()), sr

        us, (dv, sr) = timed_us(point, repeat=1)
        if n == 4:
            base = dv
        boost = dv / base - 1
        note = " paper:+159%" if n == 32 else ""
        rows.append(row(f"fig11.n{n}", us,
                        f"dV={dv*1e3:.1f}mV (+{100*boost:.0f}% vs N=4{note}) "
                        f"maj3_success={sr:.4f}"))
    return rows
