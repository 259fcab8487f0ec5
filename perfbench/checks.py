"""The numbers that decide ``correct``, each held to its limit from the
cell's file (``limits``), and how they print."""

from __future__ import annotations

import json
import statistics
import sys


def worst_leaf(prog: dict, ref: dict, keep=None,
               measure=lambda p, r: abs(p - r)) -> tuple[float, str]:
    """The worst leaf's ``measure`` of the program's reading against the
    reference's norm (by default the gap between the two norms), over the
    larger of that leaf's reference norm and the median leaf's; ``keep``
    limits the leaves compared."""
    keys = [k for k in ref if keep is None or k in keep]
    med = statistics.median(ref[k] for k in keys)
    worst, at = 0.0, ""
    for k in keys:
        gap = measure(prog[k], ref[k]) / max(ref[k], med, 1e-30)
        if gap >= worst:
            worst, at = gap, "/".join(k)
    return worst, at


def moving_leaves(ref_grad: dict, share: float = 1e-3) -> set:
    """Leaves whose first reference gradient is at least ``share`` of the
    median leaf's: the others move under AdamW by round-off alone."""
    med = statistics.median(ref_grad.values())
    return {k for k, v in ref_grad.items() if v >= share * med}


def judge(values: dict, limits: dict) -> dict:
    """``{name: {"value", "limit"}}`` for every limit; a number missing
    from ``values`` (its check could not run) fails."""
    return {k: {"value": values.get(k, float("inf")), "limit": lim}
            for k, lim in limits.items()}


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def print_checks(checks: dict, notes: dict | None = None) -> None:
    """The compared numbers, each beside its limit, as the last lines on
    standard error."""
    for k, v in (notes or {}).items():
        print(f"check note {k}: {v}", file=sys.stderr)
    for k, c in checks.items():
        ok = "ok" if c["value"] <= c["limit"] else "FAILED"
        print(f"check {k} = {json.dumps(c['value'])} limit "
              f"{json.dumps(c['limit'])} {ok}", file=sys.stderr)
    sys.stderr.flush()
