"""Input-replication planning (paper §5.1, Fig 10).

For MAJ-M executed with an N-row simultaneous activation, inputs are
"replicated to the maximum extent possible; the remaining rows are then set
to the neutral state": copies = N // M, neutrals = N - M*copies.

With M odd and equal copies c, the charge-shared vote never ties
(net = c * (ones - zeros), |ones - zeros| >= 1), so logical correctness is
preserved: MAJ_{cM+n_neutral}(replicated inputs, neutrals) == MAJ_M(inputs).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ReplicationPlan:
    m_inputs: int      # majority fan-in (odd)
    n_rg: int          # simultaneously activated rows
    copies: int        # copies of each input
    n_neutral: int     # Frac/neutral rows

    @property
    def worst_case_net_votes(self) -> int:
        """Minimum |weighted ones - zeros| over non-tie patterns."""
        return self.copies

    def row_assignment(self) -> list[int]:
        """Slot -> input index (or -1 for neutral) for the N_RG rows."""
        slots = []
        for i in range(self.m_inputs):
            slots.extend([i] * self.copies)
        slots.extend([-1] * self.n_neutral)
        return slots


def plan(m_inputs: int, n_rg: int) -> ReplicationPlan:
    if m_inputs % 2 == 0:
        raise ValueError("majority fan-in must be odd")
    if n_rg < m_inputs:
        raise ValueError(f"cannot perform MAJ{m_inputs} with only {n_rg} rows")
    copies = n_rg // m_inputs
    n_neutral = n_rg - m_inputs * copies
    return ReplicationPlan(m_inputs=m_inputs, n_rg=n_rg, copies=copies,
                           n_neutral=n_neutral)


def plan_pow2(m_inputs: int, n_rg: int) -> ReplicationPlan:
    """Staging-efficient variant: copies rounded DOWN to a power of two so
    each input occupies ONE buddy-aligned block and stages with a single
    seed RowClone + a single intra-block Multi-RowInit (2 AAPs), remaining
    rows neutral. The paper's plan (maximal copies, e.g. 10 for MAJ3@32)
    maximizes sensing margin; this one trades a little margin for init
    latency — both are exposed and the benchmarks search over them.
    """
    if m_inputs % 2 == 0:
        raise ValueError("majority fan-in must be odd")
    if n_rg < m_inputs:
        raise ValueError(f"cannot perform MAJ{m_inputs} with only {n_rg} rows")
    c = n_rg // m_inputs
    copies = 1 << (c.bit_length() - 1)
    return ReplicationPlan(m_inputs=m_inputs, n_rg=n_rg, copies=copies,
                           n_neutral=n_rg - m_inputs * copies)


def fracdram_plan(m_inputs: int = 3) -> ReplicationPlan:
    """FracDRAM baseline: MAJ3 on a 4-row activation, single copies + 1
    neutral (no replication)."""
    return ReplicationPlan(m_inputs=m_inputs, n_rg=m_inputs + 1, copies=1,
                           n_neutral=1)
