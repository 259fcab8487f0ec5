"""Port vertical evaluator vs the reference's vertical evaluators.

The reference's ``ref-vertical`` pipeline and its Pallas kernel (in
interpret mode, as the reference's own tests run it on the CPU) compile
every plane op into one XLA graph — minutes for a wide divider — so they
are held against the port's plain vertical version on programs whose
plane count keeps that compile short: every opcode at width 8, the
divider-free opcodes above it. ``test_torch_fused_program.py`` covers
every opcode at every width against the reference's word evaluators.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.kernels import fused_program as rfp
from repro_torch.convert import program_from_reference
from repro_torch.kernels import fused_program as tfp
from test_torch_fused_program import (WIDTHS, lanes_for, random_program,
                                      ref_program, run_port, run_ref,
                                      to_wire)

CHEAP = ("and", "or", "xor", "add", "sub", "less", "popcount",
         "reduce_and", "reduce_or", "reduce_xor")
# Past 16 planes the reference's XLA compile grows to tens of seconds per
# program; a shorter program still crosses the lo/hi tile boundary.
WIDE = ("xor", "sub", "less", "popcount", "reduce_and")


def _name(base, word_bits):
    return base if word_bits == 32 else f"{base}-64"


@pytest.mark.parametrize("width,word_bits", WIDTHS)
def test_vertical_matches_reference_vertical(width, word_bits):
    rng = np.random.default_rng(100 + width + word_bits)
    opcodes = tfp.OPCODES if width == 8 else CHEAP if width <= 16 else WIDE
    plain = random_program(rng, width, opcodes)
    wires = [to_wire(x, word_bits) for x in lanes_for(rng, width, 64, 3)]
    want = run_ref(plain, word_bits, _name("ref-vertical", word_bits), wires)
    got = run_port(plain, word_bits, _name("ref-vertical", word_bits), wires)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("width", [8, 16, 33])
def test_run_program_ref_matches_pallas_interpret(width):
    rng = np.random.default_rng(200 + width)
    word_bits = 32 if width <= 32 else 64
    opcodes = tfp.OPCODES if width == 8 else CHEAP if width <= 16 else WIDE
    plain = random_program(rng, width, opcodes)
    x = rng.integers(0, 2**32, (3, width, rfp.BLOCK_WORDS),
                     dtype=np.uint64).astype(np.uint32).view(np.int32)
    x[1, :, :64] = 0  # zero divisors
    want = np.asarray(rfp.run_program_pallas(ref_program(plain, word_bits),
                                             x, interpret=True))
    got = tfp.run_program_ref(program_from_reference(*plain, word_bits),
                              torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
