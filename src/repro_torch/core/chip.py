"""Logical DRAM chip model: bit-exact PuM state machine on a torch device.

The port's copy of ``repro.core.chip``. State per bank: a packed 32-bit
payload ``[rows, words]`` plus a per-row ``neutral`` mask (Frac VDD/2 rows
carry no logical value until overwritten). The payload of every bank is one
int32 tensor ``[banks, rows_per_bank, words_per_row]`` on the chip's
``torch.device`` (``"cuda"`` unless the caller passes ``device="cpu"``),
carrying the uint32 bits; the ``neutral`` flags, the decoder and the
``OpStats`` stay on the host (command streams are sequential metadata).

Every PuM mutation pairs the *logical* effect (tensor indexing on the
device) with the *command program* (commands.py) the reference schedules,
so ``OpStats`` agree with the reference's float for float. The
charge-sharing vote of an APA (:func:`majority_bits`) dispatches through
``ops.maj_n``: the MAJ-N kernel on a CUDA chip, its plain version on the
CPU. The analog layer (analog.py) independently models success rates;
``PulsarChip.apa_maj`` can apply a per-bitline stability mask drawn from it
(fault injection for the reliability tests).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import commands as cmds
from repro_torch.core.decoder import RowDecoder
from repro_torch.core.engine import resolve_device
from repro_torch.core.geometry import DramGeometry
from repro_torch.core.profiles import MfrProfile
from repro_torch.core.timing import DDR4_2400, DramTimings
from repro_torch.kernels import ops


@dataclasses.dataclass
class OpStats:
    """Cumulative cost accounting for a chip session."""
    latency_ns: float = 0.0
    energy_j: float = 0.0
    n_acts: int = 0
    n_pres: int = 0
    n_rdwr: int = 0
    n_ops: int = 0
    trace: list | None = None  # optional (op_name, latency) log

    def add(self, name: str, res: cmds.ScheduleResult) -> None:
        self.latency_ns += res.total_ns
        self.energy_j += res.energy_j
        self.n_acts += res.n_acts
        self.n_pres += res.n_pres
        self.n_rdwr += res.n_rdwr
        self.n_ops += 1
        if self.trace is not None:
            self.trace.append((name, res.total_ns))


def _popcount_rows(rows: torch.Tensor) -> torch.Tensor:
    """Per-bit-position vote count across rows: [N, W] int32 -> the K+1
    bit-planes of the count (the bit-sliced carry-save counter of the MAJ-N
    kernel, K = bit_length(N)). As in the reference, each counter plane
    starts as a zero copy of ``rows``, so the result is [K+1, N, W] with N
    equal rows."""
    n = rows.shape[0]
    k = max(1, n.bit_length())
    planes = [torch.zeros_like(rows) for _ in range(k + 1)]
    for i in range(n):
        carry = rows[i]
        for j in range(k + 1):
            t = planes[j] ^ carry
            carry = planes[j] & carry
            planes[j] = t
    return torch.stack(planes)


def majority_bits(rows, threshold: int):
    """Packed-word test (count_of_ones_per_bit >= threshold) across rows.

    rows: [N, W] int32 tensor carrying uint32 words (or a uint32 ndarray).
    threshold in [1, N]. Returns [W] of the same kind. The overflow-counter
    trick of the MAJ-N kernel, through ``ops.maj_n``: the kernel for a CUDA
    tensor, its plain version for a CPU one.
    """
    if not isinstance(rows, torch.Tensor):
        arr = np.ascontiguousarray(np.asarray(rows, np.uint32))
        out = majority_bits(torch.from_numpy(arr.view(np.int32)), threshold)
        return out.numpy().view(np.uint32)
    n = rows.shape[0]
    if not (1 <= threshold <= n):
        raise ValueError(f"threshold {threshold} out of range for {n} rows")
    return ops.maj_n(rows.contiguous(), threshold)


def _mask_to_words(mask: np.ndarray) -> np.ndarray:
    """[bits] bool -> packed uint32 words (bit 32w+b -> bit b of word w;
    little-endian platform assumed, as with all packed layouts here)."""
    bits = np.asarray(mask, np.uint8)
    if bits.size % 32:
        raise ValueError("mask length must be a multiple of 32")
    return np.packbits(bits, bitorder="little").view(np.uint32).copy()


class PulsarChip:
    """One DRAM rank (module-level lockstep) with PuM capability, its bank
    payload on ``device``."""

    def __init__(self, geometry: DramGeometry, profile: MfrProfile,
                 seed: int = 0, timings: DramTimings = DDR4_2400,
                 trace: bool = False, device="cuda"):
        self.geometry = geometry
        self.profile = profile
        self.timings = timings
        self.device = resolve_device(device)
        self.decoder = RowDecoder.build(geometry, profile, seed)
        self.scheduler = cmds.CommandScheduler(timings)
        self.rng = np.random.default_rng(seed + 0x5AF)
        g = geometry
        self.banks = torch.zeros((g.banks, g.rows_per_bank, g.words_per_row),
                                 dtype=torch.int32, device=self.device)
        self.neutral = np.zeros((g.banks, g.rows_per_bank), bool)
        self.stats = OpStats(trace=[] if trace else None)
        self._wr_bursts = max(1, g.row_bits // 512)  # BL8 x 64-bit bus
        self._indices: dict[tuple, torch.Tensor] = {}

    # ------------------------------------------------------------------ #
    # Device-side helpers
    # ------------------------------------------------------------------ #

    def _index(self, rows: tuple[int, ...]) -> torch.Tensor:
        """Row addresses as an index tensor on the device (cached: the
        executor activates the same few row sets again and again)."""
        idx = self._indices.get(rows)
        if idx is None:
            if len(self._indices) >= 4096:
                self._indices.clear()
            idx = torch.tensor(rows, dtype=torch.long, device=self.device)
            self._indices[rows] = idx
        return idx

    def _row_payload(self, data) -> torch.Tensor:
        """A row payload as int32 words on the device: a tensor, or
        anything ``np.asarray(data, np.uint32)`` takes."""
        if isinstance(data, torch.Tensor):
            if data.dtype != torch.int32:
                raise ValueError(f"row payload tensor must be int32, got "
                                 f"{data.dtype}")
            words = data.to(self.device)
        else:
            arr = np.ascontiguousarray(np.asarray(data, np.uint32))
            words = torch.from_numpy(arr.view(np.int32)).to(self.device)
        if tuple(words.shape) != (self.geometry.words_per_row,):
            raise ValueError(
                f"row payload must be [{self.geometry.words_per_row}]")
        return words

    def _fill(self, bank: int, rows: tuple[int, ...],
              words: torch.Tensor) -> None:
        """Every row of ``rows`` takes ``words`` (one indexed copy)."""
        self.banks[bank].index_copy_(
            0, self._index(rows), words.expand(len(rows), -1))

    # ------------------------------------------------------------------ #
    # Host-side (nominal-timing) access
    # ------------------------------------------------------------------ #

    def write_row(self, bank: int, row: int, data) -> None:
        self.banks[bank, row] = self._row_payload(data)
        self.neutral[bank, row] = False
        prog = cmds.prog_write_row(bank, row, self._wr_bursts, self.timings)
        self.stats.add("write_row", self.scheduler.schedule(prog))

    def read_row(self, bank: int, row: int) -> torch.Tensor:
        """The row's words as an int32 tensor on the chip's device."""
        if self.neutral[bank, row]:
            raise RuntimeError(f"reading neutral (VDD/2) row {row}: undefined data")
        prog = cmds.prog_read_row(bank, row, self._wr_bursts, self.timings)
        self.stats.add("read_row", self.scheduler.schedule(prog))
        return self.banks[bank, row].clone()

    def peek(self, bank: int, row: int) -> torch.Tensor:
        """Test-only: read without cost accounting."""
        return self.banks[bank, row].clone()

    # ------------------------------------------------------------------ #
    # PuM primitives
    # ------------------------------------------------------------------ #

    def frac(self, bank: int, row: int) -> None:
        """Put ``row`` into the neutral VDD/2 state (FracDRAM op).

        On Mfr. M (frac unsupported, footnote 4) the same logical effect is
        obtained by writing the sense-amp bias pattern; the neutral flag is
        still what the charge-sharing vote consumes.
        """
        if self.profile.frac_supported:
            prog = cmds.prog_frac(bank, row, self.timings)
            self.stats.add("frac", self.scheduler.schedule(prog))
        else:
            if not self.profile.sa_bias_neutral:
                raise RuntimeError(
                    f"Mfr {self.profile.name}: no neutral-row mechanism")
            # Mfr M: re-init the row with the bias pattern via RowClone from
            # a resident pattern row (one AAP) — a full WR stream is never
            # needed after the one-time pattern-row setup.
            prog = cmds.prog_aap_multi_row_init(bank, row, row, self.timings)
            self.stats.add("frac.bias_clone", self.scheduler.schedule(prog))
        self.neutral[bank, row] = True

    def frac_block(self, bank: int, rf: int, rs: int) -> tuple[int, ...]:
        """Put a whole decoder block into the neutral state.

        Mfr H: Frac has no multi-row variant -> one Frac per row.
        Mfr M: bias pattern re-init is a RowClone seed + one Multi-RowInit
        over the block (2 AAPs regardless of block size)."""
        rows = self.decoder.activated_rows(rf, rs)
        if self.profile.frac_supported:
            for r in rows:
                self.frac(bank, r)
            return rows
        if not self.profile.sa_bias_neutral:
            raise RuntimeError(
                f"Mfr {self.profile.name}: no neutral-row mechanism")
        prog = cmds.prog_aap_multi_row_init(bank, rf, rs, self.timings)
        self.stats.add("frac.bias_seed", self.scheduler.schedule(prog))
        if len(rows) > 1:
            self.stats.add("frac.bias_mri", self.scheduler.schedule(prog))
        for r in rows:
            self.neutral[bank, r] = True
        return rows

    def apa_maj(self, bank: int, rf: int, rs: int,
                stability_mask=None) -> tuple[int, ...]:
        """Charge-sharing APA (§5.2.2): simultaneous activation of the
        decoder-determined row set; every bitline resolves to the weighted
        majority of non-neutral activated cells; ALL activated rows and the
        row buffer take the result.

        ``stability_mask``: optional [row_bits] bool — bitlines that resolve
        correctly (from the analog model). Unstable bitlines flip to the
        complement (worst-case deterministic fault model). Packed on the
        host, as in the reference, then uploaded.
        Returns the activated row set.
        """
        rows = self.decoder.activated_rows(rf, rs)
        if len(rows) < 2:
            raise RuntimeError(
                f"APA({rf},{rs}) activated {rows}: not a multi-row group "
                f"(Mfr {self.profile.name})")
        data_rows = tuple(r for r in rows if not self.neutral[bank, r])
        n_data = len(data_rows)
        if n_data == 0:
            raise RuntimeError("charge sharing over only neutral rows")
        # Even vote counts can tie (equilibrium, §2.3); PULSAR's replication
        # plans guarantee |net| >= copies > 0 so ties never occur there. If a
        # tie does occur, the sense amp resolves to its bias (deterministic 0
        # here). Threshold count > n_data/2 ==> count >= n_data//2+1. The
        # vote rows are gathered into one contiguous [n_data, W] tensor (the
        # MAJ-N kernel takes contiguous planes).
        votes = self.banks[bank].index_select(0, self._index(data_rows))
        result = majority_bits(votes, n_data // 2 + 1)
        if stability_mask is not None:
            words = _mask_to_words(stability_mask).view(np.int32)
            result = result ^ ~torch.from_numpy(words).to(self.device)
        self._fill(bank, rows, result)
        self.neutral[bank, list(rows)] = False
        prog = cmds.prog_apa_charge_share(bank, rf, rs, self.timings)
        self.stats.add(f"apa_maj{n_data}", self.scheduler.schedule(prog))
        return rows

    def multi_row_init(self, bank: int, rf: int, rs: int) -> tuple[int, ...]:
        """Multi-RowInit (§5.2.1): copy R_F's content into every row of the
        activated group (R_F fully sensed first; sense amps overdrive)."""
        rows = self.decoder.activated_rows(rf, rs)
        if self.neutral[bank, rf]:
            raise RuntimeError("Multi-RowInit source row is neutral")
        self._fill(bank, rows, self.banks[bank, rf].clone())
        self.neutral[bank, list(rows)] = False
        # rf itself keeps its value (it is in the activated set by
        # construction when rf/rs share the subarray; if not, rs-only set
        # still gets rf's data because the sense amps latched rf).
        prog = cmds.prog_aap_multi_row_init(bank, rf, rs, self.timings)
        self.stats.add(f"multi_row_init{len(rows)}",
                       self.scheduler.schedule(prog))
        return rows

    def row_clone(self, bank: int, src: int, dst: int) -> None:
        """RowClone baseline [25, 98]: copy one row to one row (AAP)."""
        if self.neutral[bank, src]:
            raise RuntimeError("RowClone source row is neutral")
        self.banks[bank, dst] = self.banks[bank, src]
        self.neutral[bank, dst] = False
        prog = cmds.prog_aap_multi_row_init(bank, src, dst, self.timings)
        self.stats.add("row_clone", self.scheduler.schedule(prog))

    def bulk_write(self, bank: int, rf: int, rs: int,
                   data) -> tuple[int, ...]:
        """Bulk-Write (§5.2.3): one WR stream drives all activated rows."""
        rows = self.decoder.activated_rows(rf, rs)
        self._fill(bank, rows, self._row_payload(data))
        self.neutral[bank, list(rows)] = False
        prog = cmds.prog_bulk_write(bank, rf, rs, self._wr_bursts,
                                    self.timings)
        self.stats.add(f"bulk_write{len(rows)}", self.scheduler.schedule(prog))
        return rows
