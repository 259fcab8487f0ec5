"""Fig 5: potential speedup of MAJ5/7/9 over MAJ3 under the paper's
equal-latency-per-op model ("All operation models assume equal latency
values based on the state-of-the-art MAJ3") across the 7 microbenchmarks.

The PyTorch port's counterpart of
``benchmarks/fig05_majm_speedup_model.py``: the same rows and
``derived`` strings from an analytic op-count model on the host; ``run``
takes ``device`` only so that every figure module is called alike.
"""

from __future__ import annotations

import numpy as np

from benchmarks.common import Row, row, timed_us
from repro_torch.core.cost_model import CostModel

W = 32


def op_counts(maj_fan_in: int) -> dict[str, int]:
    """Pure op-count model (every MAJ op costs 1 unit)."""
    f = (maj_fan_in + 1) // 2              # AND/OR fan-in
    tree = CostModel.tree_nodes
    fa = 4 if maj_fan_in >= 5 else 6       # dual-rail full adder MAJ count
    add = W * fa
    return {
        "and": 2 * tree(2 * W, f),
        "or": 2 * tree(2 * W, f),
        "xor": 6 * (2 * W - 1),
        "add": add,
        "sub": add,
        "mul": W * W * 2 + (W - 1) * add,
        "div": W * ((W + 1) * fa + 3 * 2 * (W + 1) + 2),
    }


def run(device="cuda") -> list[Row]:
    def model():
        base = op_counts(3)
        return {m: {k: base[k] / op_counts(m)[k] for k in base}
                for m in (5, 7, 9)}

    us, sp = timed_us(model, repeat=1)
    rows: list[Row] = []
    for m, per in sp.items():
        logic = np.mean([per["and"], per["or"], per["xor"]])
        arith = np.mean([per["add"], per["sub"], per["mul"], per["div"]])
        rows.append(row(
            f"fig05.maj{m}_over_maj3", us / 3,
            f"logic={logic:.2f}x arith={arith:.2f}x "
            f"(paper MAJ9 logic avg 2.73x)"))
    return rows
