"""State carried from the reference into the port.

The reference's state is programs, success points, reliability maps,
chip-model state, tuned plans and leaf data. These helpers take plain
Python and NumPy values (never ``repro`` objects), so tests can feed the
same program, the same characterization data, the same calibrated chip,
the same simulated DRAM and the same plan to both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.autotune import TunedPlan
from repro_torch.autotune.tuner import PLAN_SCHEMA
from repro_torch.backends import select_backend
from repro_torch.core.charact import SuccessRateDb
from repro_torch.core.chip import OpStats, PulsarChip
from repro_torch.core.decoder import RowDecoder
from repro_torch.core.geometry import DramGeometry
from repro_torch.core.profiles import PROFILES
from repro_torch.kernels.fused_program import FusedOp, FusedProgram
from repro_torch.kernels.plane_layout import get_layout
from repro_torch.reliability.calibration import ReliabilityMap


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


def reliability_map_from_reference(*, mfr, seed, n_subarrays, n_columns,
                                   configs, success, flip_p,
                                   bank_scale) -> ReliabilityMap:
    """The port's :class:`ReliabilityMap` from a reference map's plain
    fields (``configs`` as ``(m_inputs, n_rg)`` pairs, the three arrays as
    NumPy). The arrays are copied, so the two maps share no memory; with
    it both packages plan, inject and vote on the same calibrated chip."""
    return ReliabilityMap(
        mfr=str(mfr), seed=int(seed), n_subarrays=int(n_subarrays),
        n_columns=int(n_columns),
        configs=tuple((int(m), int(n)) for m, n in configs),
        success=np.array(success, np.float64),
        flip_p=np.array(flip_p, np.float32),
        bank_scale=np.array(bank_scale, np.float64))


def chip_from_reference(*, geometry, profile: str, banks, neutral,
                        yield_mask, seed: int = 0, stats=None,
                        device="cuda") -> PulsarChip:
    """The port's :class:`PulsarChip` on ``device`` from a reference chip's
    plain state: ``geometry`` as a dict of ``DramGeometry`` fields,
    ``profile`` the manufacturer name (``"H"``, ``"M"``, ``"S"``),
    ``banks`` the payload ``[banks, rows_per_bank, words_per_row]`` as
    NumPy uint32, ``neutral`` the per-row flags, ``yield_mask`` the
    decoder's ``(subarrays, groups)`` mask or ``None`` (perfect yield) and
    ``stats`` an optional dict of ``OpStats`` fields to continue from. The
    arrays are copied, so the two chips share no memory."""
    geom = DramGeometry(**{k: (tuple(v) if k == "predecoder_widths" else v)
                           for k, v in dict(geometry).items()})
    prof = PROFILES[str(profile)]
    chip = PulsarChip(geom, prof, seed=int(seed), device=device)
    payload = np.ascontiguousarray(np.asarray(banks, np.uint32))
    flags = np.asarray(neutral, bool)
    if payload.shape != tuple(chip.banks.shape) \
            or flags.shape != chip.neutral.shape:
        raise ValueError(
            f"state of shape {payload.shape} / {flags.shape} does not fit "
            f"the geometry {tuple(chip.banks.shape)}")
    chip.banks.copy_(torch.from_numpy(payload.view(np.int32)))
    chip.neutral[...] = flags
    chip.decoder = RowDecoder(
        geom, prof, None if yield_mask is None
        else np.array(yield_mask, bool))
    if stats is not None:
        fields = {k: v for k, v in dict(stats).items() if k != "trace"}
        chip.stats = OpStats(**fields)
    return chip


def plan_from_reference(plan, device="cuda") -> TunedPlan:
    """The port's :class:`TunedPlan` from a reference plan's ``as_dict()``
    payload (or anything with an ``as_dict()`` giving it). Its fused
    backend becomes the port's backend of the same plane layout available
    on ``device`` (``words-cpu*``, ``pallas-tpu*`` and ``shard-words``
    become ``words-torch*`` on the CPU and ``vertical-cuda*`` on a CUDA
    device; ``ref-vertical*`` keeps its name); every other knob, the
    scores, the estimate and the profile carry over unchanged."""
    d = dict(plan.as_dict() if hasattr(plan, "as_dict") else plan)
    if not str(d["fused_backend"]).startswith("ref-vertical"):
        d["fused_backend"] = select_backend(
            require="fused", device=device,
            layout=int(d["word_bits"])).name
    d["schema"] = PLAN_SCHEMA
    return TunedPlan.from_dict(d)
