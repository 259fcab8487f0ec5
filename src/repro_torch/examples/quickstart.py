"""Quickstart: PULSAR in-DRAM computing on the simulated chip.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The port's counterpart of ``examples/quickstart.py``, its chip's bank
payload on the card by default. Walks the paper's core mechanisms
end-to-end on the bit-exact chip model: many-row activation, input
replication, MAJ, Multi-RowInit, Bulk-Write, and the bit-serial ALU —
with real command-level latency accounting.
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import (MFR_H, BitSerialAlu, DramGeometry, PulsarChip,
                              PulsarExecutor, default_db, majority_bits)

GEOM = DramGeometry(row_bits=256, rows_per_subarray=256, subarrays_per_bank=2,
                    banks=1, predecoder_widths=(2, 2, 2, 2))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    chip = PulsarChip(GEOM, MFR_H, seed=0, device=args.device)
    chip.decoder = chip.decoder.__class__(GEOM, MFR_H, None)  # perfect yield
    x = PulsarExecutor(chip, bank=0, subarray=0)

    print("== Simultaneous many-row activation (paper §4) ==")
    rf, rs = chip.decoder.find_group_pair(0, 16)
    rows = chip.decoder.activated_rows(rf, rs)
    print(f"APA(ACT {rf} -> PRE -> ACT {rs}) activates {len(rows)} rows: "
          f"{rows[:6]}...")

    print("\n== MAJ3 with input replication (paper §5.1) ==")
    rng = np.random.default_rng(0)
    vals = [rng.integers(0, 2**32, GEOM.words_per_row, dtype=np.uint64)
            .astype(np.uint32) for _ in range(3)]
    for i, v in enumerate(vals):
        chip.write_row(0, 200 + i, v)
    rep = x.maj(240, [200, 201, 202], n_rg=16)
    got = chip.peek(0, 240).cpu().numpy().view(np.uint32)
    want = majority_bits(np.stack(vals), 2)
    print(f"MAJ3 @ N_RG=16: copies={rep.copies} neutrals={rep.n_neutral} "
          f"correct={np.array_equal(got, want)}")
    db = default_db()
    print(f"modeled success rate: FracDRAM(N=4) {db.mean('H', 3, 4):.3f} "
          f"-> PULSAR(N=32) {db.mean('H', 3, 32):.3f} "
          f"(paper: 0.789 -> 0.979)")

    print("\n== Multi-RowInit & Bulk-Write (paper §5.2) ==")
    t0 = chip.stats.latency_ns
    x.multi_row_init_block(200, 16)
    print(f"Multi-RowInit 1->16 rows in {chip.stats.latency_ns - t0:.0f} ns "
          f"(vs ~16 RowClones)")
    t0 = chip.stats.latency_ns
    x.bulk_write_block(np.zeros(GEOM.words_per_row, np.uint32), 16)
    print(f"Bulk-Write 16 rows in {chip.stats.latency_ns - t0:.0f} ns")

    print("\n== Bit-serial SIMD ALU over bitlines (paper §6.1.2) ==")
    alu = BitSerialAlu(PulsarExecutor(chip, 0, 1), width=8)
    a = rng.integers(0, 200, GEOM.row_bits, dtype=np.uint64)
    b = rng.integers(1, 50, GEOM.row_bits, dtype=np.uint64)
    va, vb = alu.load(a), alu.load(b)
    t0 = chip.stats.latency_ns
    s = alu.store(alu.add(va, vb))
    dt = chip.stats.latency_ns - t0
    print(f"{GEOM.row_bits}-lane 8-bit add: correct="
          f"{np.array_equal(s, (a + b) & 0xFF)} in {dt*1e-3:.1f} us "
          f"({GEOM.row_bits/dt:.3f} adds/ns in-DRAM)")
    q, r = alu.div(va, vb)
    print(f"{GEOM.row_bits}-lane 8-bit div: correct="
          f"{np.array_equal(alu.store(q), a // b)}")
    print(f"\ntotal session: {chip.stats.n_ops} PuM ops, "
          f"{chip.stats.latency_ns*1e-3:.1f} us, "
          f"{chip.stats.energy_j*1e6:.2f} uJ")


if __name__ == "__main__":
    main()
