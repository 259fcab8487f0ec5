"""Dual-rail bit-serial ALU on the PULSAR executor (paper §2.4, §6.1.2).

The port's copy of ``repro.core.alu``: pure Python over the executor, so
its MAJ command programs, ``op_counts`` and the chip's ``OpStats`` are the
reference's. Operands enter and leave through the host (``to_vertical`` /
``from_vertical`` in NumPy); on the chip they are rows of its bank tensor.

Operands are vertical-layout vectors: ``width`` bit-planes plus ``width``
*negated* planes (prior work [25] stores both rails because MAJ gates cannot
implement NOT; majority is self-dual, so every op maintains the negated rail
with the dual MAJ at 2x op cost).

Building blocks:
  * AND-f / OR-f via MAJ_(2f-1) with (f-1) constant all-0 / all-1 rows,
  * full adder: Cout = MAJ3(A,B,Cin); Sum = MAJ5(A,B,Cin,¬Cout,¬Cout)
    (Navi et al. [75]; needs MAJ5 => PULSAR's arithmetic speedup),
    MAJ3-only fallback: Sum = MAJ3(¬Cout, Cin, MAJ3(A,B,¬Cin)) (Ali [4]),
  * XOR = OR(AND(a,¬b), AND(¬a,b)),
  * shifts are free (plane renaming — the vertical layout's raison d'etre),
  * ADD/SUB ripple carry, MUL shift-add, DIV restoring with bit-plane mux.

The ALU executes *real command programs* against the logical chip model —
results are bit-exact vs NumPy (tests) and every op's latency/energy lands in
``chip.stats``. ``op_counts`` mirrors what the closed-form cost model
(cost_model.py) predicts; the two are cross-checked in tests.

Row ownership: a ``Vec`` may alias rows it does not own (constant planes,
renamed shifts, other vectors' planes). Only ``alloc_vec``/op outputs own
their rows; ``free`` must only ever be called on owned vectors — internal
code is careful to respect this.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.chip import PulsarChip
from repro_torch.core.layout import from_vertical, to_vertical
from repro_torch.core.pulsar import PulsarExecutor


@dataclasses.dataclass
class Vec:
    """Handle to a dual-rail vertical vector resident in DRAM rows."""
    width: int
    pos_rows: list[int]   # plane j -> row holding bit j of each element
    neg_rows: list[int]

    def shifted_left(self, k: int, zero_row: int, one_row: int) -> "Vec":
        """x << k: free plane renaming; low planes become constant 0.
        The result ALIASES self's rows — do not free it."""
        return Vec(self.width,
                   [zero_row] * k + self.pos_rows[: self.width - k],
                   [one_row] * k + self.neg_rows[: self.width - k])

    def zero_extended(self, width: int, zero_row: int, one_row: int) -> "Vec":
        if width < self.width:
            raise ValueError("cannot shrink")
        pad = width - self.width
        return Vec(width, self.pos_rows + [zero_row] * pad,
                   self.neg_rows + [one_row] * pad)


class BitSerialAlu:
    def __init__(self, executor: PulsarExecutor, width: int = 32,
                 max_n_rg: int | None = None):
        self.x = executor
        self.chip: PulsarChip = executor.chip
        self.bank = executor.bank
        self.width = width
        geom = self.chip.geometry
        self.words = geom.words_per_row
        cap = executor.max_n_rg()
        self.n_rg = min(max_n_rg or cap, cap)
        if self.n_rg < 4:
            raise RuntimeError("need at least 4-row activation for MAJ3")
        # Home region: rows outside the compute N_RG hold operand planes.
        region_rows = set(executor.region(self.n_rg).rows_by_combo)
        sa = executor.subarray
        base = sa * geom.rows_per_subarray
        self._free_rows = [r for r in range(base, base + geom.rows_per_subarray)
                           if r not in region_rows]
        self.op_counts: dict[str, int] = {}
        # Constant rows (written once; staged into N_RGs like any operand).
        self.zero_row = self._alloc()
        self.one_row = self._alloc()
        self.chip.write_row(self.bank, self.zero_row,
                            np.zeros(self.words, np.uint32))
        self.chip.write_row(self.bank, self.one_row,
                            np.full(self.words, 0xFFFFFFFF, np.uint32))

    # ------------------------------------------------------------------ #

    def _alloc(self) -> int:
        if not self._free_rows:
            raise RuntimeError("subarray out of rows; free some vectors")
        return self._free_rows.pop()

    def free(self, v: Vec) -> None:
        self._free_rows.extend(v.pos_rows)
        self._free_rows.extend(v.neg_rows)
        v.pos_rows, v.neg_rows = [], []

    def _count(self, name: str, n: int = 1) -> None:
        self.op_counts[name] = self.op_counts.get(name, 0) + n

    @property
    def maj_fan_in(self) -> int:
        """Largest odd MAJ fan-in the configured N_RG supports (N_RG >= M)."""
        return self.n_rg - 1 if self.n_rg % 2 == 0 else self.n_rg

    @property
    def and_or_fan_in(self) -> int:
        """AND-f needs MAJ_(2f-1): f = (M+1)/2."""
        return (self.maj_fan_in + 1) // 2

    # ------------------------------------------------------------------ #
    # Data movement
    # ------------------------------------------------------------------ #

    def load(self, values: np.ndarray, width: int | None = None) -> Vec:
        """Host -> DRAM: writes both rails (negated data precomputed on the
        host, as in prior work [25]). The planes go to the chip's device in
        one copy; each row write is then a copy on the device."""
        width = width or self.width
        values = np.asarray(values, np.uint64) & np.uint64((1 << width) - 1)
        planes = torch.from_numpy(to_vertical(values, width).view(np.int32))
        planes = planes.to(self.chip.device)
        v = Vec(width, [self._alloc() for _ in range(width)],
                [self._alloc() for _ in range(width)])
        for j in range(width):
            self.chip.write_row(self.bank, v.pos_rows[j], planes[j])
            self.chip.write_row(self.bank, v.neg_rows[j], ~planes[j])
        return v

    def store(self, v: Vec, signed: bool = False) -> np.ndarray:
        """DRAM -> host: the positive rail's rows, read into one host copy."""
        planes = torch.stack([self.chip.read_row(self.bank, r)
                              for r in v.pos_rows])
        return from_vertical(planes.cpu().numpy().view(np.uint32),
                             signed=signed)

    def alloc_vec(self, width: int | None = None) -> Vec:
        width = width or self.width
        return Vec(width, [self._alloc() for _ in range(width)],
                   [self._alloc() for _ in range(width)])

    def notted(self, v: Vec) -> Vec:
        """NOT is free: swap rails (result aliases v — do not free)."""
        return Vec(v.width, list(v.neg_rows), list(v.pos_rows))

    def const_vec(self, width: int | None = None) -> Vec:
        """All-zero vector aliasing the constant rows (do not free)."""
        width = width or self.width
        return Vec(width, [self.zero_row] * width, [self.one_row] * width)

    def copy(self, v: Vec) -> Vec:
        """Materialize an owned copy (RowClone per plane)."""
        out = self.alloc_vec(v.width)
        for j in range(v.width):
            self.chip.row_clone(self.bank, v.pos_rows[j], out.pos_rows[j])
            self.chip.row_clone(self.bank, v.neg_rows[j], out.neg_rows[j])
        self._count("rowclone", 2 * v.width)
        return out

    # ------------------------------------------------------------------ #
    # MAJ plumbing: every logical op is a dual pair of MAJ executions.
    # ------------------------------------------------------------------ #

    def _maj_pair(self, dst_pos: int, dst_neg: int, pos_srcs: list[int],
                  neg_srcs: list[int]) -> None:
        m = len(pos_srcs)
        if m > self.n_rg:
            raise ValueError(f"MAJ{m} needs N_RG >= {m}, have {self.n_rg}")
        self.x.maj(dst_pos, pos_srcs, self.n_rg)
        self.x.maj(dst_neg, neg_srcs, self.n_rg)
        self._count(f"maj{m}", 2)

    def _and_rows(self, dst_pos: int, dst_neg: int,
                  pos: list[int], neg: list[int]) -> None:
        pad = len(pos) - 1
        self._maj_pair(dst_pos, dst_neg, pos + [self.zero_row] * pad,
                       neg + [self.one_row] * pad)

    def _or_rows(self, dst_pos: int, dst_neg: int,
                 pos: list[int], neg: list[int]) -> None:
        pad = len(pos) - 1
        self._maj_pair(dst_pos, dst_neg, pos + [self.one_row] * pad,
                       neg + [self.zero_row] * pad)

    # ------------------------------------------------------------------ #
    # Fan-in reduction trees (the Fig 5 / Fig 17 speedup lever)
    # ------------------------------------------------------------------ #

    def _tree_reduce(self, pos_list: list[int], neg_list: list[int],
                     kind: str) -> tuple[int, int]:
        """Reduce planes with AND-f/OR-f nodes of fan-in
        ``self.and_or_fan_in``; frees intermediate scratch greedily.
        Returns an OWNED (pos_row, neg_row)."""
        f = self.and_or_fan_in
        pos, neg = list(pos_list), list(neg_list)
        owned = [False] * len(pos)
        while len(pos) > 1:
            npos, nneg, nown = [], [], []
            for i in range(0, len(pos), f):
                cp, cn, co = pos[i:i + f], neg[i:i + f], owned[i:i + f]
                if len(cp) == 1:
                    npos.append(cp[0]); nneg.append(cn[0]); nown.append(co[0])
                    continue
                dp, dn = self._alloc(), self._alloc()
                if kind == "and":
                    self._and_rows(dp, dn, cp, cn)
                else:
                    self._or_rows(dp, dn, cp, cn)
                for p, n, o in zip(cp, cn, co):
                    if o:
                        self._free_rows.extend([p, n])
                npos.append(dp); nneg.append(dn); nown.append(True)
            pos, neg, owned = npos, nneg, nown
        if not owned[0]:  # degenerate single-plane input: materialize
            dp, dn = self._alloc(), self._alloc()
            self.chip.row_clone(self.bank, pos[0], dp)
            self.chip.row_clone(self.bank, neg[0], dn)
            return dp, dn
        return pos[0], neg[0]

    def reduce_planes(self, v: Vec, kind: str) -> Vec:
        """AND/OR-reduce all planes of ``v`` to a 1-bit vector."""
        p, n = self._tree_reduce(v.pos_rows, v.neg_rows, kind)
        return Vec(1, [p], [n])

    def xor_reduce_planes(self, v: Vec) -> Vec:
        """Parity across planes (binary XOR tree; XOR has no wide-fan-in MAJ
        shortcut in our synthesis — see cost_model notes)."""
        pos, neg = list(v.pos_rows), list(v.neg_rows)
        owned = [False] * len(pos)
        while len(pos) > 1:
            npos, nneg, nown = [], [], []
            for i in range(0, len(pos) - 1, 2):
                r = self.xor(Vec(1, [pos[i]], [neg[i]]),
                             Vec(1, [pos[i + 1]], [neg[i + 1]]))
                for j in (i, i + 1):
                    if owned[j]:
                        self._free_rows.extend([pos[j], neg[j]])
                npos.append(r.pos_rows[0]); nneg.append(r.neg_rows[0])
                nown.append(True)
            if len(pos) % 2:
                npos.append(pos[-1]); nneg.append(neg[-1]); nown.append(owned[-1])
            pos, neg, owned = npos, nneg, nown
        if not owned[0]:
            dp, dn = self._alloc(), self._alloc()
            self.chip.row_clone(self.bank, pos[0], dp)
            self.chip.row_clone(self.bank, neg[0], dn)
            return Vec(1, [dp], [dn])
        return Vec(1, [pos[0]], [neg[0]])

    # ------------------------------------------------------------------ #
    # Element-wise logic
    # ------------------------------------------------------------------ #

    def _zip_op(self, a: Vec, b: Vec, kind: str) -> Vec:
        if a.width != b.width:
            raise ValueError("width mismatch")
        out = self.alloc_vec(a.width)
        for j in range(a.width):
            args = ([a.pos_rows[j], b.pos_rows[j]],
                    [a.neg_rows[j], b.neg_rows[j]])
            if kind == "and":
                self._and_rows(out.pos_rows[j], out.neg_rows[j], *args)
            else:
                self._or_rows(out.pos_rows[j], out.neg_rows[j], *args)
        return out

    def and_(self, a: Vec, b: Vec) -> Vec:
        return self._zip_op(a, b, "and")

    def or_(self, a: Vec, b: Vec) -> Vec:
        return self._zip_op(a, b, "or")

    def xor(self, a: Vec, b: Vec) -> Vec:
        """XOR = OR(AND(a,¬b), AND(¬a,b)) per plane, dual-rail."""
        if a.width != b.width:
            raise ValueError("width mismatch")
        out = self.alloc_vec(a.width)
        t1, t1n, t2, t2n = (self._alloc() for _ in range(4))
        for j in range(a.width):
            self._and_rows(t1, t1n, [a.pos_rows[j], b.neg_rows[j]],
                           [a.neg_rows[j], b.pos_rows[j]])
            self._and_rows(t2, t2n, [a.neg_rows[j], b.pos_rows[j]],
                           [a.pos_rows[j], b.neg_rows[j]])
            self._or_rows(out.pos_rows[j], out.neg_rows[j], [t1, t2],
                          [t1n, t2n])
        self._free_rows.extend([t1, t1n, t2, t2n])
        return out

    # ------------------------------------------------------------------ #
    # Arithmetic
    # ------------------------------------------------------------------ #

    def _full_adder(self, ap: int, an: int, bp: int, bn: int,
                    cp: int, cn: int, sp: int, sn: int,
                    coutp: int, coutn: int) -> None:
        """One dual-rail full adder; MAJ5 path when available (PULSAR),
        MAJ3-only path otherwise (FracDRAM baseline)."""
        self._maj_pair(coutp, coutn, [ap, bp, cp], [an, bn, cn])
        if self.maj_fan_in >= 5:
            # Sum = MAJ5(A, B, Cin, ¬Cout, ¬Cout): the doubled operand is
            # weighted naturally by input replication (Fig 10).
            self._maj_pair(sp, sn, [ap, bp, cp, coutn, coutn],
                           [an, bn, cn, coutp, coutp])
        else:
            tp, tn = self._alloc(), self._alloc()
            # inner = MAJ3(A, B, ¬Cin); Sum = MAJ3(¬Cout, Cin, inner)
            self._maj_pair(tp, tn, [ap, bp, cn], [an, bn, cp])
            self._maj_pair(sp, sn, [coutn, cp, tp], [coutp, cn, tn])
            self._free_rows.extend([tp, tn])

    def add(self, a: Vec, b: Vec, cin_one: bool = False) -> Vec:
        """Ripple-carry a + b (mod 2^width)."""
        if a.width != b.width:
            raise ValueError("width mismatch")
        out = self.alloc_vec(a.width)
        cp = self.one_row if cin_one else self.zero_row
        cn = self.zero_row if cin_one else self.one_row
        c0p, c0n, c1p, c1n = (self._alloc() for _ in range(4))
        for j in range(a.width):
            ncp, ncn = (c0p, c0n) if j % 2 == 0 else (c1p, c1n)
            self._full_adder(a.pos_rows[j], a.neg_rows[j],
                             b.pos_rows[j], b.neg_rows[j], cp, cn,
                             out.pos_rows[j], out.neg_rows[j], ncp, ncn)
            cp, cn = ncp, ncn
        self._free_rows.extend([c0p, c0n, c1p, c1n])
        return out

    def sub(self, a: Vec, b: Vec) -> Vec:
        """a - b = a + ¬b + 1 (two's complement)."""
        return self.add(a, self.notted(b), cin_one=True)

    def mul(self, a: Vec, b: Vec) -> Vec:
        """Shift-add multiply, low ``width`` bits."""
        w = a.width
        acc = self.and_(a, self._broadcast_plane(b, 0, w))
        for j in range(1, w):
            masked = self.and_(a, self._broadcast_plane(b, j, w))
            shifted = masked.shifted_left(j, self.zero_row, self.one_row)
            nxt = self.add(acc, shifted)
            self.free(acc)
            self.free(masked)   # shifted aliased masked; both consumed
            acc = nxt
        return acc

    def _broadcast_plane(self, v: Vec, j: int, width: int) -> Vec:
        """All planes alias plane j of v (free bit-replication)."""
        return Vec(width, [v.pos_rows[j]] * width, [v.neg_rows[j]] * width)

    def mux(self, sel: Vec, t: Vec, f: Vec) -> Vec:
        """Per-element select: sel ? t : f (sel is 1-bit, broadcast)."""
        w = t.width
        sel_b = self._broadcast_plane(sel, 0, w)
        x = self.and_(t, sel_b)
        y = self.and_(f, self.notted(sel_b))
        out = self.or_(x, y)
        self.free(x)
        self.free(y)
        return out

    def div(self, a: Vec, b: Vec) -> tuple[Vec, Vec]:
        """Unsigned restoring division -> (quotient, remainder).

        Internally extends to width+1 bits so the trial subtraction's sign
        bit is exact (invariant: rem < b => rem' = 2*rem + a_j < 2b <= 2^(w+1)).
        Caller contract (as in prior work): b != 0 elementwise.
        """
        w = a.width
        we = w + 1
        bx = b.zero_extended(we, self.zero_row, self.one_row)  # alias
        rem = self.const_vec(we)  # alias of constant zero planes
        rem_owned = False
        qplanes: list[tuple[int, int]] = []
        for j in reversed(range(w)):
            # rem' = (rem << 1) | a_j  — pure aliasing
            shifted = Vec(we, [a.pos_rows[j]] + rem.pos_rows[:we - 1],
                          [a.neg_rows[j]] + rem.neg_rows[:we - 1])
            t = self.sub(shifted, bx)                      # owned
            sign = Vec(1, [t.pos_rows[we - 1]], [t.neg_rows[we - 1]])
            new_rem = self.mux(sign, shifted, t)           # owned
            qp, qn = self._alloc(), self._alloc()
            self.chip.row_clone(self.bank, t.neg_rows[we - 1], qp)
            self.chip.row_clone(self.bank, t.pos_rows[we - 1], qn)
            self._count("rowclone", 2)
            qplanes.append((qp, qn))
            self.free(t)
            if rem_owned:
                self.free(rem)
            rem, rem_owned = new_rem, True
        qplanes.reverse()
        quo = Vec(w, [p for p, _ in qplanes], [n for _, n in qplanes])
        # Shrink remainder to w planes; free the top plane.
        self._free_rows.extend([rem.pos_rows[w], rem.neg_rows[w]])
        rem = Vec(w, rem.pos_rows[:w], rem.neg_rows[:w])
        return quo, rem

    def popcount_planes(self, v: Vec, out_width: int | None = None) -> Vec:
        """Per-element popcount over the planes of v (serial accumulation of
        zero-extended bits; each step is a ripple add)."""
        w_out = out_width or max(1, v.width.bit_length())
        acc: Vec | None = None
        for j in range(v.width):
            ext = Vec(w_out,
                      [v.pos_rows[j]] + [self.zero_row] * (w_out - 1),
                      [v.neg_rows[j]] + [self.one_row] * (w_out - 1))
            if acc is None:
                acc = self.copy(ext)
            else:
                nxt = self.add(acc, ext)
                self.free(acc)
                acc = nxt
        assert acc is not None
        return acc

    def less_than(self, a: Vec, b: Vec) -> Vec:
        """Unsigned a < b via sign of extended subtraction (1-bit vector)."""
        we = a.width + 1
        ax = a.zero_extended(we, self.zero_row, self.one_row)
        bx = b.zero_extended(we, self.zero_row, self.one_row)
        t = self.sub(ax, bx)
        sp, sn = self._alloc(), self._alloc()
        self.chip.row_clone(self.bank, t.pos_rows[we - 1], sp)
        self.chip.row_clone(self.bank, t.neg_rows[we - 1], sn)
        self._count("rowclone", 2)
        self.free(t)
        return Vec(1, [sp], [sn])
