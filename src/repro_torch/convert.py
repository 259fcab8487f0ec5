"""State carried from the reference into the port.

The reference's state is programs, success points and leaf data. These
helpers take plain Python and NumPy values (never ``repro`` objects), so
tests can feed the same program and the same characterization data to
both packages.
"""

from __future__ import annotations

from repro_torch.core.charact import SuccessRateDb
from repro_torch.kernels.fused_program import FusedOp, FusedProgram
from repro_torch.kernels.plane_layout import get_layout


def program_from_reference(width: int, n_inputs: int, ops, outputs,
                           word_bits: int = 32) -> FusedProgram:
    """The port's :class:`FusedProgram` from a reference program's plain
    fields: ``ops`` as ``(opcode, args, param)`` tuples, ``outputs`` as
    value ids, ``word_bits`` its layout's word size."""
    return FusedProgram(
        width=int(width), n_inputs=int(n_inputs),
        ops=tuple(FusedOp(str(opc), tuple(int(a) for a in args), int(param))
                  for opc, args, param in ops),
        outputs=tuple(int(v) for v in outputs),
        layout=get_layout(word_bits))


def program_to_plain(program: FusedProgram) -> tuple:
    """``(width, n_inputs, ops, outputs, word_bits)`` with ``ops`` as
    ``(opcode, args, param)`` tuples — the inverse of
    :func:`program_from_reference` (and the same shape for a reference
    program, whose fields have the same names)."""
    return (program.width, program.n_inputs,
            tuple((op.opcode, tuple(op.args), op.param)
                  for op in program.ops),
            tuple(program.outputs), program.layout.word_bits)


def success_db_from_points(points) -> SuccessRateDb:
    """A :class:`SuccessRateDb` from the reference's ``SuccessPoint``
    fields as plain values: an iterable of dicts with ``mfr``,
    ``m_inputs``, ``n_rg``, ``mean``, ``q1``, ``q3``, ``lo``, ``hi`` and
    the ``plan_style`` the point was queried with."""
    rows = []
    for p in points:
        rows.append({"mfr": str(p["mfr"]), "m_inputs": int(p["m_inputs"]),
                     "n_rg": int(p["n_rg"]),
                     "mean": float(p["mean"]), "q1": float(p["q1"]),
                     "q3": float(p["q3"]), "lo": float(p["lo"]),
                     "hi": float(p["hi"]),
                     "plan_style": str(p["plan_style"])})
    return SuccessRateDb(rows)
