"""The port's chip model (decoder, chip, executor, ALU, destruction) against
the reference, on the CPU.

Every case builds the same chip in both packages — the port's from the
reference's plain state through ``convert.chip_from_reference`` — runs the
same op sequence on both with the same seeded NumPy inputs, and holds the
results, the bank payload and ``neutral`` flags, ``OpStats``, the ALU's
``op_counts`` and the ``DestructionReport``s equal (tolerance 0: it is all
integer, and the float sums of ``OpStats`` add the same terms in the same
order). Geometries are the reference suite's (``tests/core/test_chip_alu.py``
and ``test_decoder.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import destruction as rdestruction
from repro.core import layout as rlayout
from repro.core.alu import BitSerialAlu as RAlu
from repro.core.chip import (PulsarChip as RChip, _popcount_rows as r_popcount,
                             majority_bits as r_majority_bits)
from repro.core.cost_model import CostModel as RCostModel
from repro.core.decoder import RowDecoder as RDecoder
from repro.core.geometry import DramGeometry as RGeometry
from repro.core.profiles import PROFILES as RPROFILES
from repro.core.pulsar import PulsarExecutor as RExecutor
from repro.core.pulsar import build_region as r_build_region
from repro_torch import convert
from repro_torch.core import destruction as tdestruction
from repro_torch.core import layout as tlayout
from repro_torch.core.alu import BitSerialAlu as TAlu
from repro_torch.core.chip import (PulsarChip as TChip,
                                   _popcount_rows as t_popcount,
                                   majority_bits as t_majority_bits)
from repro_torch.core.cost_model import CostModel as TCostModel
from repro_torch.core.decoder import RowDecoder as TDecoder
from repro_torch.core.geometry import DramGeometry as TGeometry
from repro_torch.core.profiles import PROFILES as TPROFILES
from repro_torch.core.pulsar import PulsarExecutor as TExecutor
from repro_torch.core.pulsar import build_region as t_build_region
from repro_torch.kernels import ops

# tests/core/test_chip_alu.py's GEOM, tests/core/test_decoder.py's G9 and
# the repo's TEST_GEOMETRY.
GEOMS = {
    "alu": dict(row_bits=256, rows_per_subarray=256, subarrays_per_bank=2,
                banks=1, predecoder_widths=(2, 2, 2, 2)),
    "g9": dict(row_bits=1024, rows_per_subarray=512, subarrays_per_bank=2,
               banks=1),
    "test": dict(row_bits=1024, rows_per_subarray=64, subarrays_per_bank=2,
                 banks=2, predecoder_widths=(2, 2, 2)),
}


def words_of(x) -> np.ndarray:
    """A port row/plane tensor (int32) as the reference's uint32 words."""
    return x.cpu().numpy().view(np.uint32)


def chip_pair(profile="H", geom="alu", seed=0, full_yield=True):
    """(reference chip, port chip on the CPU) in the same state."""
    rgeom = RGeometry(**GEOMS[geom])
    rchip = RChip(rgeom, RPROFILES[profile], seed=seed)
    if full_yield:
        rchip.decoder = RDecoder(rgeom, RPROFILES[profile], None)
    tchip = convert.chip_from_reference(
        geometry=dataclasses.asdict(rgeom), profile=profile,
        banks=rchip.banks, neutral=rchip.neutral,
        yield_mask=rchip.decoder.yield_mask, seed=seed,
        stats=dataclasses.asdict(rchip.stats), device="cpu")
    return rchip, tchip


def assert_same_chip(rchip, tchip):
    np.testing.assert_array_equal(words_of(tchip.banks), rchip.banks)
    np.testing.assert_array_equal(tchip.neutral, rchip.neutral)
    assert dataclasses.asdict(tchip.stats) == dataclasses.asdict(rchip.stats)


def rand_rows(rng, n, words):
    return [rng.integers(0, 2**32, words, dtype=np.uint64).astype(np.uint32)
            for _ in range(n)]


# --------------------------------------------------------------------- #
# Layout and the decoder (host NumPy in both packages)


@pytest.mark.parametrize("width", [1, 5, 8, 31, 32, 33, 63, 64])
def test_layout_bit_exact(width):
    rng = np.random.default_rng(width)
    hi = 2**64 - 1 if width == 64 else (1 << width) - 1
    v = rng.integers(0, hi, 256, dtype=np.uint64, endpoint=True)
    planes = tlayout.to_vertical(v, width)
    np.testing.assert_array_equal(planes, rlayout.to_vertical(v, width))
    for signed in (False, True):
        np.testing.assert_array_equal(
            tlayout.from_vertical(planes, signed=signed),
            rlayout.from_vertical(planes, signed=signed))
    np.testing.assert_array_equal(tlayout.from_vertical(planes), v)
    bits = tlayout.unpack_bits(planes[0])
    np.testing.assert_array_equal(bits, rlayout.unpack_bits(planes[0]))
    np.testing.assert_array_equal(tlayout.pack_bits(bits), planes[0])


@pytest.mark.parametrize("profile", ["H", "M", "S"])
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_decoder_matches_reference(profile, seed):
    for geom in ("test", "g9"):
        tg, rg = TGeometry(**GEOMS[geom]), RGeometry(**GEOMS[geom])
        td = TDecoder.build(tg, TPROFILES[profile], seed)
        rd = RDecoder.build(rg, RPROFILES[profile], seed)
        np.testing.assert_array_equal(td.yield_mask, rd.yield_mask)
        # The port's chip draws the same decoder from the same seed.
        chip = TChip(tg, TPROFILES[profile], seed=seed, device="cpu")
        np.testing.assert_array_equal(chip.decoder.yield_mask, rd.yield_mask)
        rng = np.random.default_rng(seed)
        n = tg.rows_per_bank
        for rf, rs in rng.integers(0, n, (300, 2)):
            assert td.activated_rows(int(rf), int(rs)) == \
                rd.activated_rows(int(rf), int(rs))
        for sa in range(tg.subarrays_per_bank):
            for n_rows in (2, 4, 8, 16, 32):
                got = want = None
                try:
                    want = rd.find_group_pair(sa, n_rows,
                                              np.random.default_rng(seed))
                except ValueError as e:
                    want = str(e)
                try:
                    got = td.find_group_pair(sa, n_rows,
                                             np.random.default_rng(seed))
                except ValueError as e:
                    got = str(e)
                assert got == want
                row = sa * tg.rows_per_subarray + 5
                try:
                    want = rd.find_group_pair(sa, n_rows, include=(row,))
                except ValueError as e:
                    want = str(e)
                try:
                    got = td.find_group_pair(sa, n_rows, include=(row,))
                except ValueError as e:
                    got = str(e)
                assert got == want
            assert td.nrg_census(sa, sample=400, seed=seed) == \
                rd.nrg_census(sa, sample=400, seed=seed)
        if geom == "test":  # exact census: 64 * 63 ordered pairs
            assert td.nrg_census(0) == rd.nrg_census(0)


# --------------------------------------------------------------------- #
# The charge-sharing vote


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 17, 32, 33, 40])
def test_majority_bits_matches_reference(n):
    rng = np.random.default_rng(n)
    rows = rng.integers(0, 2**32, (n, 37), dtype=np.uint64).astype(np.uint32)
    rows[:, :3] = 0xFFFFFFFF
    for t in sorted({1, n // 2 + 1, n}):
        want = r_majority_bits(rows, t)
        np.testing.assert_array_equal(t_majority_bits(rows, t), want)
        got = t_majority_bits(torch.from_numpy(rows.view(np.int32)), t)
        np.testing.assert_array_equal(words_of(got), want)
    np.testing.assert_array_equal(
        words_of(t_popcount(torch.from_numpy(rows.view(np.int32)))),
        r_popcount(rows))
    with pytest.raises(ValueError, match="out of range"):
        t_majority_bits(rows, n + 1)


def test_apa_votes_through_maj_n_dispatch(monkeypatch):
    calls = []
    real = ops.maj_n

    def spy(x, threshold):
        calls.append((tuple(x.shape), threshold, x.is_contiguous()))
        return real(x, threshold)

    monkeypatch.setattr(ops, "maj_n", spy)
    rchip, tchip = chip_pair("H")
    rx, tx = RExecutor(rchip, 0, 0), TExecutor(tchip, 0, 0)
    rng = np.random.default_rng(3)
    for i, d in enumerate(rand_rows(rng, 3, rchip.geometry.words_per_row)):
        rchip.write_row(0, 200 + i, d)
        tchip.write_row(0, 200 + i, d)
    rx.maj(240, [200, 201, 202], 8)
    tx.maj(240, [200, 201, 202], 8)
    assert_same_chip(rchip, tchip)
    # One vote over the 6 data rows of the 8-row region (2 neutrals).
    assert calls == [((6, tchip.geometry.words_per_row), 4, True)]


# --------------------------------------------------------------------- #
# The chip's primitives and the executor


def _seq_maj(chips, execs, rng, profile, n_rg, m, plan_style):
    words = chips[0].geometry.words_per_row
    srcs = list(range(200, 200 + m))
    for r, d in zip(srcs, rand_rows(rng, m, words)):
        for c in chips:
            c.write_row(0, r, d)
    return [dataclasses.asdict(x.maj(240, srcs, n_rg, plan_style=plan_style))
            for x in execs]


MAJ_CASES = [("H", n, m, ps) for n in (4, 8, 16) for m in (3, 5)
             for ps in ("pow2", "max") if n >= m] + \
            [("M", n, 3, ps) for n in (4, 8, 16) for ps in ("pow2", "max")]


@pytest.mark.parametrize("profile,n_rg,m,plan_style", MAJ_CASES)
def test_executor_maj_matches_reference(profile, n_rg, m, plan_style):
    """MAJ-M at N_RG with either plan; on Mfr M the neutral rows are the
    bias-pattern writes (footnote 4)."""
    rchip, tchip = chip_pair(profile)
    execs = [RExecutor(rchip, 0, 0), TExecutor(tchip, 0, 0)]
    rng = np.random.default_rng(n_rg * 10 + m)
    rep_r, rep_t = _seq_maj((rchip, tchip), execs, rng, profile, n_rg, m,
                            plan_style)
    assert rep_t == rep_r
    assert_same_chip(rchip, tchip)
    region_r, region_t = execs[0].region(n_rg), execs[1].region(n_rg)
    assert dataclasses.asdict(region_t) == dataclasses.asdict(region_r)
    assert execs[1].max_n_rg() == execs[0].max_n_rg()


def test_primitives_match_reference():
    """write/read, Frac, Multi-RowInit, Bulk-Write, RowClone, the FracDRAM
    baseline and the stability mask, on one chip with a drawn decoder."""
    rchip, tchip = chip_pair("H", geom="g9", seed=3, full_yield=False)
    g = rchip.geometry
    rng = np.random.default_rng(11)
    rx, tx = RExecutor(rchip, 0, 0), TExecutor(tchip, 0, 0)
    data = rand_rows(rng, 5, g.words_per_row)
    for i, d in enumerate(data):
        rchip.write_row(0, 300 + i, d)
        tchip.write_row(0, 300 + i, d)
    np.testing.assert_array_equal(words_of(tchip.read_row(0, 301)),
                                  rchip.read_row(0, 301))
    n_max = rx.max_n_rg()
    assert tx.max_n_rg() == n_max
    assert tx.multi_row_init_block(300, n_max) == \
        rx.multi_row_init_block(300, n_max)
    assert tx.bulk_write_block(data[1], 4) == rx.bulk_write_block(data[1], 4)
    tchip.row_clone(0, 302, 7)
    rchip.row_clone(0, 302, 7)
    rchip.frac(0, 9)
    tchip.frac(0, 9)
    with pytest.raises(RuntimeError, match="neutral"):
        tchip.read_row(0, 9)
    with pytest.raises(RuntimeError, match="neutral"):
        tchip.row_clone(0, 9, 10)
    region = rx.region(4)
    assert tchip.frac_block(0, region.rf, region.rs) == \
        rchip.frac_block(0, region.rf, region.rs)
    assert dataclasses.asdict(tx.fracdram_maj3(310, [300, 301, 302])) == \
        dataclasses.asdict(rx.fracdram_maj3(310, [300, 301, 302]))
    mask = rng.random(g.row_bits) < 0.9
    rx.maj(311, [300, 303, 304], 4, stability_mask=mask)
    tx.maj(311, [300, 303, 304], 4, stability_mask=mask)
    assert_same_chip(rchip, tchip)
    with pytest.raises(RuntimeError, match="not a multi-row group"):
        tchip.apa_maj(0, 5, 5)
    with pytest.raises(ValueError, match="row payload"):
        tchip.write_row(0, 1, np.zeros(3, np.uint32))


@pytest.mark.parametrize("profile", ["H", "M"])
def test_stability_mask_flips_unstable_bitlines(profile):
    rchip, tchip = chip_pair(profile)
    w = rchip.geometry.words_per_row
    datas = [np.zeros(w, np.uint32), np.zeros(w, np.uint32),
             np.full(w, 0xFFFFFFFF, np.uint32)]
    mask = np.ones(rchip.geometry.row_bits, bool)
    mask[:32] = False  # first word unstable
    for chip, x in ((rchip, RExecutor(rchip, 0, 0)),
                    (tchip, TExecutor(tchip, 0, 0))):
        for i, d in enumerate(datas):
            chip.write_row(0, 200 + i, d)
        x.maj(240, [200, 201, 202], n_rg=8, stability_mask=mask)
    got = words_of(tchip.peek(0, 240))
    assert got[0] == 0xFFFFFFFF and (got[1:] == 0).all()
    assert_same_chip(rchip, tchip)


def test_chained_in_place_input_matches_reference():
    rchip, tchip = chip_pair("H")
    execs = (RExecutor(rchip, 0, 0), TExecutor(tchip, 0, 0))
    rng = np.random.default_rng(5)
    for i, d in enumerate(rand_rows(rng, 5, rchip.geometry.words_per_row)):
        rchip.write_row(0, 200 + i, d)
        tchip.write_row(0, 200 + i, d)
    reports = []
    for x in execs:
        x.maj(240, [200, 201, 202], n_rg=8)
        reports.append(dataclasses.asdict(
            x.maj(241, [240, 203, 204], n_rg=8, in_place_input=0)))
        x.maj(242, [240, 203, 204], n_rg=8)
    assert reports[1] == reports[0]
    assert reports[1]["n_copy_in"] < 3
    assert_same_chip(rchip, tchip)
    # The residency check is the model's invariant: a row that is not
    # resident in the region is refused, as in the reference.
    for x in execs:
        with pytest.raises(RuntimeError, match="not resident"):
            x.maj(243, [203, 200, 201], n_rg=8, in_place_input=0)


def test_build_region_matches_reference():
    for n_rg in (2, 4, 8, 16):
        rchip, tchip = chip_pair("H", geom="g9", seed=2)
        rr = r_build_region(rchip, 0, 1, n_rg, seed=n_rg)
        tr = t_build_region(tchip, 0, 1, n_rg, seed=n_rg)
        assert dataclasses.asdict(tr) == dataclasses.asdict(rr)
        assert tr.block_anchor_pair(0, 2) == rr.block_anchor_pair(0, 2)


# --------------------------------------------------------------------- #
# The bit-serial ALU


def _alu_pair(width, profile, n_rg):
    rchip, tchip = chip_pair(profile)
    return (rchip, tchip,
            RAlu(RExecutor(rchip, 0, 0), width=width, max_n_rg=n_rg),
            TAlu(TExecutor(tchip, 0, 0), width=width, max_n_rg=n_rg))


def _rand(width, seed, n=256):
    return np.random.default_rng(seed).integers(0, 1 << width, n,
                                                dtype=np.uint64)


def _run_logic(alu, a, b):
    va, vb = alu.load(a), alu.load(b)
    return [alu.store(alu.and_(va, vb)), alu.store(alu.or_(va, vb)),
            alu.store(alu.xor(va, vb))]


def _run_add_sub(alu, a, b):
    va, vb = alu.load(a), alu.load(b)
    s = alu.add(va, vb)
    out = [alu.store(s), alu.store(alu.sub(va, vb)),
           alu.store(alu.add(va, vb, cin_one=True))]
    alu.free(s)
    return out


def _run_mul(alu, a, b):
    va, vb = alu.load(a), alu.load(b)
    return [alu.store(alu.mul(va, vb))]


def _run_div(alu, a, b):
    va, vb = alu.load(a), alu.load(b | 1)
    q, r = alu.div(va, vb)
    return [alu.store(q), alu.store(r)]


def _run_reduce(alu, a, b):
    va = alu.load(a)
    return [alu.store(alu.reduce_planes(va, "and")),
            alu.store(alu.reduce_planes(va, "or")),
            alu.store(alu.xor_reduce_planes(va)),
            alu.store(alu.copy(va), signed=True)]


def _run_popcount_lt(alu, a, b):
    va, vb = alu.load(a), alu.load(b)
    return [alu.store(alu.popcount_planes(va)),
            alu.store(alu.less_than(va, vb)),
            alu.store(alu.mux(alu.less_than(va, vb), va, vb))]


ALU_RUNS = {"logic": (_run_logic, 8), "add_sub": (_run_add_sub, 8),
            "mul": (_run_mul, 8), "div": (_run_div, 6),
            "reduce": (_run_reduce, 8), "popcount_lt": (_run_popcount_lt, 8)}
# MAJ5 full adders at N_RG 16 and 8 (Mfr H), the MAJ3-only fallback at
# N_RG 4, and Mfr M's bias-pattern neutrals at 8.
FAN_INS = [("H", 16), ("H", 4), ("M", 8)]


@pytest.mark.parametrize("op", sorted(ALU_RUNS))
@pytest.mark.parametrize("profile,n_rg", FAN_INS)
def test_alu_matches_reference(op, profile, n_rg):
    run, width = ALU_RUNS[op]
    rchip, tchip, ralu, talu = _alu_pair(width, profile, n_rg)
    assert talu.maj_fan_in == ralu.maj_fan_in
    a, b = _rand(width, 1 + n_rg), _rand(width, 2 + n_rg)
    want = run(ralu, a, b)
    got = run(talu, a, b)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert talu.op_counts == ralu.op_counts
    assert sorted(talu._free_rows) == sorted(ralu._free_rows)
    assert_same_chip(rchip, tchip)


def test_alu_add_is_the_bitserial_add_kernel():
    """The ALU's command-level add and K4's plain version agree on the
    same planes (K4 is held against ``BitSerialAlu.add``)."""
    _, tchip, _, talu = _alu_pair(8, "H", 16)
    a, b = _rand(8, 3), _rand(8, 4)
    va, vb = talu.load(a), talu.load(b)
    s = talu.add(va, vb)
    planes = [torch.stack([tchip.peek(0, r) for r in v.pos_rows])
              for v in (va, vb, s)]
    np.testing.assert_array_equal(
        ops.bitserial_add(planes[0], planes[1]).numpy(), planes[2].numpy())
    np.testing.assert_array_equal(talu.store(s), (a + b) & 0xFF)


# --------------------------------------------------------------------- #
# Cold-boot destruction


@pytest.mark.parametrize("profile,full_yield", [("H", True), ("H", False),
                                                ("M", True)])
def test_destruction_matches_reference(profile, full_yield):
    rchip, tchip = chip_pair(profile, geom="g9", seed=4,
                             full_yield=full_yield)
    rng = np.random.default_rng(9)
    g = rchip.geometry
    secret = rng.integers(0, 2**32, (g.rows_per_bank, g.words_per_row),
                          dtype=np.uint64).astype(np.uint32)
    rchip.banks[0] = secret
    tchip.banks[0] = torch.from_numpy(secret.view(np.int32))
    reports = []
    for mod, chip in ((rdestruction, rchip), (tdestruction, tchip)):
        reports.append([dataclasses.asdict(mod.destroy_bank_pulsar(
            chip, 0, pattern=0x5A5A5A5A))])
    assert reports[1] == reports[0]
    assert (words_of(tchip.banks[0]) == 0x5A5A5A5A).all()
    assert_same_chip(rchip, tchip)
    for mod, chip in ((rdestruction, rchip), (tdestruction, tchip)):
        reports.append(dataclasses.asdict(
            mod.destroy_bank_rowclone(chip, 0, pattern=7)))
    assert reports[3] == reports[2]
    assert (words_of(tchip.banks[0]) == 7).all()
    for mod, chip in ((rdestruction, rchip), (tdestruction, tchip)):
        reports.append(dataclasses.asdict(mod.destroy_bank_fracdram(chip, 0)))
    assert reports[5] == reports[4]
    assert tchip.neutral[0].all()
    assert_same_chip(rchip, tchip)


def test_destruction_costs_match_reference():
    rc, tc = RCostModel(), TCostModel()
    for rows, sas, block in ((512, 16, 32), (512, 16, 16), (64, 2, 8)):
        assert tdestruction.plan_pulsar_cover(rows, sas, block) == \
            rdestruction.plan_pulsar_cover(rows, sas, block)
        pairs = [(tdestruction.pulsar_destruction_cost(tc, rows, sas, block),
                  rdestruction.pulsar_destruction_cost(rc, rows, sas, block)),
                 (tdestruction.rowclone_destruction_cost(tc, rows * sas),
                  rdestruction.rowclone_destruction_cost(rc, rows * sas)),
                 (tdestruction.fracdram_destruction_cost(tc, rows * sas),
                  rdestruction.fracdram_destruction_cost(rc, rows * sas))]
        for t, r in pairs:
            assert dataclasses.asdict(t) == dataclasses.asdict(r)


def test_chip_from_reference_refuses_a_foreign_shape():
    rchip, _ = chip_pair("H")
    with pytest.raises(ValueError, match="does not fit"):
        convert.chip_from_reference(
            geometry=dataclasses.asdict(rchip.geometry), profile="H",
            banks=rchip.banks[:, :10], neutral=rchip.neutral,
            yield_mask=None, device="cpu")


def test_cuda_chip_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        TChip(TGeometry(**GEOMS["test"]), TPROFILES["H"])
