"""Buddy packing of a replication plan into an N_RG region (paper §5).

Only :func:`buddy_assign` is here: the cost model prices MAJ staging from
it. The chip-model executor it comes from (``PulsarExecutor``,
``NrgRegion``, ``build_region``) arrives with the chip-model slice.

Per-op cost (AAP = one violated-timing ACT->PRE->ACT):
    copy-ins   = (#binary blocks of c) RowClones          per input
    fills      = (#blocks with size > 1) Multi-RowInits   per input
    neutrals   = n_neutral Frac ops
    compute    = 1 APA (charge share)
    copy-out   = 1 RowClone
"""

from __future__ import annotations


def buddy_assign(m_inputs: int, copies: int, n_neutral: int, k: int
                 ) -> tuple[list[list[tuple[int, int]]], list[tuple[int, int]]]:
    """Pack m_inputs * copies + n_neutral slots into the 2^k combo hypercube.

    Returns (per-input block lists, neutral blocks); blocks are (start, size),
    buddy-aligned. Total demand always equals 2^k (replication plan invariant),
    so the packing is exact.
    """
    demands: list[tuple[int, int]] = []   # (owner, size); owner -1 = neutral
    for owner, count in [(i, copies) for i in range(m_inputs)] + [(-1, n_neutral)]:
        c = count
        bit = 1
        while c:
            if c & 1:
                demands.append((owner, bit))
            c >>= 1
            bit <<= 1
    demands.sort(key=lambda d: -d[1])
    free: dict[int, list[int]] = {1 << k: [0]}  # size -> [starts]
    per_input: list[list[tuple[int, int]]] = [[] for _ in range(m_inputs)]
    neutral_blocks: list[tuple[int, int]] = []
    for owner, size in demands:
        s = size
        while s <= (1 << k) and not free.get(s):
            s <<= 1
        if s > (1 << k):
            raise RuntimeError("buddy packing failed (invariant violated)")
        start = free[s].pop(0)
        while s > size:  # split down
            s >>= 1
            free.setdefault(s, []).append(start + s)
        block = (start, size)
        if owner < 0:
            neutral_blocks.append(block)
        else:
            per_input[owner].append(block)
    return per_input, neutral_blocks
