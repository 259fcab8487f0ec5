"""Port fused-program compiler and evaluators vs the JAX reference.

The same seeded numpy programs and lanes go through ``repro`` (the
reference) and ``repro_torch`` (the port); every integer result must be
bit-exact. The word evaluators cover every opcode at every width; the
reference's vertical evaluators are held against the port in
``test_torch_fused_vertical.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.kernels import fused_program as rfp
from repro.kernels.fused_program import FusedOp as RefOp
from repro.kernels.fused_program import FusedProgram as RefProgram
from repro.kernels.plane_layout import get_layout as ref_layout
from repro_torch.convert import program_from_reference, program_to_plain
from repro_torch.kernels import codegen
from repro_torch.kernels import fused_program as tfp

UNARY = ("popcount", "reduce_and", "reduce_or", "reduce_xor")
# (width, layout word bits): every width the issue names, plus narrow
# values carried on 64-bit lanes.
WIDTHS = [(8, 32), (16, 32), (32, 32), (33, 64), (48, 64), (64, 64),
          (16, 64)]


def random_program(rng, width: int, opcodes=tfp.OPCODES, n_inputs=3):
    """Plain-tuple program using every opcode of ``opcodes`` once (in a
    seeded order), operands drawn from earlier values; tuple values only
    feed selectors. Returns ``(width, n_inputs, ops, outputs)``."""
    ops: list = []
    values = list(range(n_inputs))

    def pick():
        return int(rng.choice(values))

    def add(opcode, args, param=0):
        ops.append((opcode, tuple(args), param))
        return n_inputs + len(ops) - 1

    order = list(opcodes)
    rng.shuffle(order)
    for opc in order:
        if opc in ("divmod", "fst", "snd"):
            pair = add("divmod", (pick(), pick()))
            sels = ("fst", "snd") if opc == "divmod" else (opc,)
            for s in sels:
                values.append(add(s, (pair,)))
        elif opc in UNARY:
            param = 0
            if opc == "reduce_and":
                param = int(rng.choice([0, width // 2 + 1, width,
                                        width + 3]))
            values.append(add(opc, (pick(),), param))
        else:
            values.append(add(opc, (pick(), pick())))
    op_vals = values[n_inputs:]
    outs = sorted(set(int(v) for v in rng.choice(op_vals, 4)) | {op_vals[-1]})
    return width, n_inputs, tuple(ops), tuple(outs)


def ref_program(plain, word_bits):
    width, n_in, ops, outs = plain
    return RefProgram(width=width, n_inputs=n_in,
                      ops=tuple(RefOp(o, a, p) for o, a, p in ops),
                      outputs=outs, layout=ref_layout(word_bits))


def lanes_for(rng, width: int, n: int, n_inputs: int) -> list:
    """Random width-bit lanes with boundary values (0, 1, max, max-1, the
    top bit) and zero divisors in every input."""
    hi = 1 << width
    out = []
    for _ in range(n_inputs):
        x = rng.integers(0, hi, n, dtype=np.uint64) if width < 64 else \
            rng.integers(0, 2**64 - 1, n, dtype=np.uint64, endpoint=True)
        x[:6] = [0, 1, hi - 1, hi - 2, 1 << (width - 1), 0]
        x[rng.random(n) < 0.1] = 0
        out.append(x)
    return out


def to_wire(x: np.ndarray, word_bits: int) -> np.ndarray:
    return np.ascontiguousarray(
        x.astype(np.uint32 if word_bits == 32 else np.uint64)).view(np.int32)


def run_ref(plain, word_bits, backend, wires):
    pipe = rfp.get_pipeline(ref_program(plain, word_bits), backend=backend)
    return [np.asarray(o, np.int32) for o in pipe(*wires)]


def run_port(plain, word_bits, backend, wires):
    prog = program_from_reference(*plain, word_bits)
    pipe = tfp.get_pipeline(prog, device="cpu", backend=backend)
    return [o.numpy() for o in pipe(*[torch.from_numpy(w) for w in wires])]


def _name(base, word_bits):
    return base if word_bits == 32 else f"{base}-64"


# --------------------------------------------------------------------- #
# optimize_program
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("seed", range(6))
def test_optimize_program_matches_reference(seed):
    rng = np.random.default_rng(seed)
    width, wb = WIDTHS[seed % len(WIDTHS)]
    plain = random_program(rng, width, tfp.OPCODES * 2)
    # Duplicate and commuted ops give CSE something to unify.
    w, n_in, ops, outs = plain
    dup = tuple((o, tuple(reversed(a)), p) for o, a, p in ops
                if o in ("and", "add", "mul"))
    plain = (w, n_in, ops + dup, outs + (n_in + len(ops) + len(dup) - 1,))
    want_prog, want_pos, want_map = rfp.optimize_program(
        ref_program(plain, wb))
    got_prog, got_pos, got_map = tfp.optimize_program(
        program_from_reference(*plain, wb))
    assert program_to_plain(got_prog) == program_to_plain(want_prog)
    assert (got_pos, got_map) == (want_pos, want_map)


# --------------------------------------------------------------------- #
# Word and vertical evaluators, every opcode, every width
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("width,word_bits", WIDTHS)
def test_word_and_vertical_match_reference_words(width, word_bits):
    rng = np.random.default_rng(width * 7 + word_bits)
    for _ in range(2):
        plain = random_program(rng, width)
        wires = [to_wire(x, word_bits) for x in lanes_for(rng, width, 96, 3)]
        want = run_ref(plain, word_bits, _name("words-cpu", word_bits), wires)
        for backend in ("words-torch", "ref-vertical", "vertical-cuda"):
            got = run_port(plain, word_bits, _name(backend, word_bits),
                           wires)
            for g, w in zip(got, want, strict=True):
                np.testing.assert_array_equal(g, w, err_msg=backend)


def test_pair_divmod_boundaries():
    """64-bit divmod on (lo, hi) halves at the values where a signed or
    truncated implementation breaks: dividends and divisors at and above
    2^63, divisor 0 and 1, equal operands."""
    vals = np.array([0, 1, 2, 3, 2**31, 2**32 - 1, 2**32, 2**32 + 1,
                     2**63 - 1, 2**63, 2**63 + 1, 2**64 - 2, 2**64 - 1],
                    np.uint64)
    a, b = (x.ravel() for x in np.meshgrid(vals, vals))
    n = -(-a.size // 32) * 32
    a, b = np.resize(a, n), np.resize(b, n)
    plain = (64, 2, (("divmod", (0, 1), 0), ("fst", (2,), 0),
                     ("snd", (2,), 0)), (3, 4))
    wires = [to_wire(a, 64), to_wire(b, 64)]
    got = run_port(plain, 64, "words-torch-64", wires)
    with np.errstate(divide="ignore", invalid="ignore"):
        q, r = a // b, a % b
    np.testing.assert_array_equal(got[0].view(np.uint64), q)
    np.testing.assert_array_equal(got[1].view(np.uint64), r)
    want = run_ref(plain, 64, "words-cpu-64", wires)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)


# --------------------------------------------------------------------- #
# The fused-program kernel's generated source, interpreted on the CPU
# --------------------------------------------------------------------- #


def interpret(program, x: np.ndarray) -> np.ndarray:
    """Run the generated kernel's IR (``codegen.generate``) on uint32
    planes ``[n_in, width, W]`` with numpy — the statements the CUDA
    source renders, one word column per lane."""
    stmts, _ = codegen.generate(program)
    n = x.shape[2]
    env: dict = {}
    out = np.zeros((len(program.outputs), program.width, n), np.uint32)

    def val(v):
        return np.full(n, v, np.uint32) if isinstance(v, int) else env[v]

    def run(block, i=None):
        for st in block:
            kind = st[0]
            if kind == "load":
                env[st[1]] = x[st[2], st[3]]
            elif kind == "op":
                a = val(st[3])
                env[st[1]] = ~a if st[2] == "~" else {
                    "&": np.bitwise_and, "|": np.bitwise_or,
                    "^": np.bitwise_xor}[st[2]](a, val(st[4]))
            elif kind == "store":
                out[st[1], st[2]] = val(st[3])
            elif kind == "array":
                env[st[1]] = [val(s) for s in st[2]]
            elif kind == "zeros":
                env[st[1]] = [None] * st[2]
            elif kind == "var":
                env[st[1]] = np.zeros(n, np.uint32)
            elif kind == "loop":
                for j in reversed(range(st[1])):
                    run(st[2], j)
            elif kind == "index":
                env[st[1]] = env[st[2]][i]
            elif kind == "store_i":
                env[st[1]][i] = val(st[2])
            elif kind in ("mov", "assign"):
                env[st[1]] = val(st[2])
            elif kind == "read":
                env[st[1]] = env[st[2]][st[3]]
            else:
                raise AssertionError(f"unknown statement {kind}")

    run(stmts)
    return out


@pytest.mark.parametrize("width,word_bits", WIDTHS)
def test_generated_kernel_matches_plain_version(width, word_bits):
    rng = np.random.default_rng(300 + width + word_bits)
    plain = random_program(rng, width)
    prog = program_from_reference(*plain, word_bits)
    x = rng.integers(0, 2**32, (3, width, 64),
                     dtype=np.uint64).astype(np.uint32)
    x[1, :, :8] = 0  # zero divisors
    want = tfp.run_program_ref(prog, torch.from_numpy(x.view(np.int32)))
    np.testing.assert_array_equal(interpret(prog, x),
                                  want.numpy().view(np.uint32))


def test_generated_kernel_constant_divisor():
    """A divisor made of constant planes (reduce_and past the width is
    all-zero) folds the divider's compare away: the remainder registers
    then shift into each other and must be assigned in parallel."""
    plain = (16, 2, (("reduce_and", (1,), 40), ("divmod", (0, 2), 0),
                     ("fst", (3,), 0), ("snd", (3,), 0),
                     ("less", (0, 1), 0), ("mod", (1, 6), 0)), (4, 5, 7))
    prog = program_from_reference(*plain, 32)
    x = np.random.default_rng(0).integers(
        0, 2**32, (2, 16, 32), dtype=np.uint64).astype(np.uint32)
    want = tfp.run_program_ref(prog, torch.from_numpy(x.view(np.int32)))
    np.testing.assert_array_equal(interpret(prog, x),
                                  want.numpy().view(np.uint32))


def test_generated_source_is_deterministic_and_keyed(monkeypatch):
    rng = np.random.default_rng(7)
    p1 = program_from_reference(*random_program(rng, 16), 32)
    p2 = program_from_reference(*random_program(rng, 16), 32)
    name1, src1 = codegen.build_item(p1)
    codegen.generate.cache_clear()
    codegen.build_item.cache_clear()
    again = codegen.build_item(p1)
    assert again == (name1, src1)          # same program, same text
    name2, src2 = codegen.build_item(p2)
    assert name2 != name1 and src2 != src1  # other program, other text
    assert "fused_program_launch" in src1 and "sm_90a" not in src1
    # A change to the generator's own sources changes the library name,
    # so a stale library can never be served.
    codegen.build_item.cache_clear()
    monkeypatch.setattr(codegen, "_generator_text",
                        lambda: "an edited generator")
    assert codegen.build_item(p1)[0] != name1
    assert codegen.build_item(p1)[1] == src1
    codegen.build_item.cache_clear()
