"""Code generator for the fused-program CUDA kernel (sm_90a).

Replaces the TPU kernel ``repro/kernels/fused_program.py::
run_program_pallas`` (body ``_program_kernel``): the whole
:class:`~repro_torch.kernels.fused_program.FusedProgram` evaluated on
vertical planes, ``[n_in, width, W] -> [n_out, width, W]`` int32, every
intermediate in fast memory. The program is static there too (a static
jit argument), so here one kernel is generated per program structure.

How the source is made: the port's own plane algebra (``ref.plane_*``
through ``fused_program.eval_fused_ops``) is traced over symbolic planes
(:class:`Sym`) whose ``& | ^ ~`` emit statements instead of computing —
the way Pallas traces jnp. Constants fold (``x & 0``, ``x ^ x``, ``~~x``)
and identical statements are shared (value numbering), so the emitted
program is the algebra's own, minus what constant planes make free. The
restoring divider is the exception: traced straight, a width-64 divmod is
~40k plane ops, so it is emitted as a runtime loop whose body is one
traced ``ref.divmod_step`` (the remainder planes live in registers, the
dividend and quotient planes in a small local array).

The generator produces a small IR (list of tuples, see :func:`generate`);
:func:`render` turns it into CUDA C with one thread per word column ``w``:
the thread loads its ``n_in * width`` input planes as first used (loads
coalesce across ``w``), runs the straight-line program in registers and
stores ``n_out * width`` planes. The kernel is bound by device-memory bytes
(4 bytes per plane per word column, each read or written once) unless the
program has many ops per plane (mul, divmod), where the integer op rate
bounds it.

The generated source is deterministic for a program; the library is keyed
on a hash of the program and of the generator's own sources (this module,
``ref.py`` and ``fused_program.py``), so a change to the generator
rebuilds instead of serving a stale library.
"""

from __future__ import annotations

import functools
import pathlib

import torch

from repro_torch.kernels import _build, fused_program, ref

NAME = "run_program_cuda"
BLOCK = 256
ONES = 0xFFFFFFFF
_GENERATOR_SOURCES = tuple(
    pathlib.Path(m.__file__) for m in (fused_program, ref)) + (
    pathlib.Path(__file__),)


class Sym:
    """A symbolic 32-bit plane: a named value of the generated kernel, or
    a constant (``const`` is 0 or ``ONES``)."""

    __slots__ = ("g", "name", "const", "neg", "load", "var")

    def __init__(self, g, name=None, const=None, load=None, var=False):
        self.g = g
        self.name = name
        self.const = const
        self.neg = None      # Sym this one is the complement of
        self.load = load     # (input, plane) for an input plane
        self.var = var       # mutable loop register (divider remainder)

    def ref(self):
        """IR operand: the constant, or the name (loading on first use)."""
        if self.const is not None:
            return self.const
        if self.load is not None:
            self.g.use_input(self)
        return self.name

    def __and__(self, other):
        return self.g.binop("&", self, other)

    def __or__(self, other):
        return self.g.binop("|", self, other)

    def __xor__(self, other):
        return self.g.binop("^", self, other)

    def __invert__(self):
        return self.g.invert(self)


class _Gen:
    def __init__(self):
        self.stmts: list = []    # current block
        self.memo: dict = {}     # (op, operands) -> Sym, per block scope
        self.loaded: set = set()
        self.n = 0
        self.n_ops = 0           # logic ops executed per word column
        self.n_loops = 0
        self.in_loop = False
        self.zero = Sym(self, const=0)
        self.ones = Sym(self, const=ONES)

    def fresh(self, **kw) -> Sym:
        s = Sym(self, name=f"v{self.n}", **kw)
        self.n += 1
        return s

    def constant(self, value: int) -> Sym:
        return self.zero if value == 0 else self.ones

    def use_input(self, s: Sym) -> None:
        if s.name in self.loaded:
            return
        if self.in_loop:  # callers load a loop's inputs before it
            raise RuntimeError(f"input plane {s.load} first used in a loop")
        self.loaded.add(s.name)
        self.stmts.append(("load", s.name) + s.load)

    def emit_op(self, op: str, a: Sym, b: Sym | None = None) -> Sym:
        key = (op, a.name) if b is None else \
            (op,) + tuple(sorted((a.name, b.name)))
        hit = self.memo.get(key)
        if hit is not None:
            return hit
        args = (a.ref(),) if b is None else (a.ref(), b.ref())
        out = self.fresh()
        self.stmts.append(("op", out.name, op) + args)
        self.n_ops += 1
        self.memo[key] = out
        return out

    def binop(self, op: str, a: Sym, b: Sym) -> Sym:
        if a.const is not None and b.const is not None:
            return self.constant(a.const & b.const if op == "&"
                                 else a.const | b.const if op == "|"
                                 else a.const ^ b.const)
        if a.const is not None:  # all three ops commute: constant second
            a, b = b, a
        if b.const is not None:
            if op == "&":
                return a if b.const else self.zero
            if op == "|":
                return self.ones if b.const else a
            return ~a if b.const else a
        if a.name == b.name:
            return self.zero if op == "^" else a
        return self.emit_op(op, a, b)

    def invert(self, a: Sym) -> Sym:
        if a.const is not None:
            return self.constant(a.const ^ ONES)
        if a.neg is not None:
            return a.neg
        out = self.emit_op("~", a)
        out.neg = a
        return out

    def input(self, i: int, j: int) -> Sym:
        return self.fresh(load=(i, j))

    def store(self, t: int, j: int, s: Sym) -> None:
        self.stmts.append(("store", t, j, s.ref()))

    def plane_divmod(self, a: list, b: list) -> tuple[list, list]:
        """``ref.plane_divmod`` as a runtime loop over the dividend's
        planes, MSB first: the body is one traced ``ref.divmod_step``."""
        width = len(a)
        k = self.n_loops
        self.n_loops += 1
        arr, qarr = f"a{k}", f"q{k}"
        self.stmts.append(("array", arr, [s.ref() for s in a]))
        for s in b:
            s.ref()
        self.stmts.append(("zeros", qarr, width))
        rem = [Sym(self, name=f"r{k}_{j}", var=True) for j in range(width)]
        for r in rem:
            self.stmts.append(("var", r.name))
        outer, outer_memo = self.stmts, self.memo
        self.stmts, self.memo, self.in_loop = [], dict(outer_memo), True
        n0 = self.n_ops
        abit = self.fresh()
        self.stmts.append(("index", abit.name, arr))
        qbit, new_rem = ref.divmod_step(rem, abit, b)
        self.stmts.append(("store_i", qarr, qbit.ref()))
        # Parallel assignment: snapshot sources that are themselves
        # remainder registers before any register is overwritten.
        srcs = []
        for s in new_rem:
            if s.var:
                c = self.fresh()
                self.stmts.append(("mov", c.name, s.name))
                s = c
            srcs.append(s.ref())
        for r, s in zip(rem, srcs):
            self.stmts.append(("assign", r.name, s))
        body = self.stmts
        self.n_ops = n0 + (self.n_ops - n0) * width
        self.stmts, self.memo, self.in_loop = outer, outer_memo, False
        self.stmts.append(("loop", width, body))
        quot = []
        for j in range(width):
            q = self.fresh()
            self.stmts.append(("read", q.name, qarr, j))
            quot.append(q)
        nonzero = ref.plane_reduce(b, "or")
        return [q & nonzero for q in quot], [r & nonzero for r in rem]


@functools.lru_cache(maxsize=256)
def generate(program) -> tuple[list, int]:
    """``(ir, n_ops)`` for ``program``: the kernel body as IR statements,
    and the logic ops it executes per word column.

    Statements (operands are value names or the constants 0/``ONES``):
    ``("load", dst, i, j)`` input plane (i, j); ``("op", dst, op, a[, b])``
    with op in ``& | ^ ~``; ``("store", t, j, src)`` output plane (t, j);
    ``("array", name, srcs)`` a local array; ``("zeros", name, n)``;
    ``("var", name)`` a register starting at 0; ``("loop", n, body)`` runs
    body for i = n-1 .. 0; inside it ``("index", dst, arr)`` reads
    arr[i], ``("store_i", arr, src)`` writes arr[i], ``("mov", dst, src)``
    and ``("assign", var, src)``; ``("read", dst, arr, k)`` reads arr[k].
    """
    g = _Gen()
    env = [[g.input(i, j) for j in range(program.width)]
           for i in range(program.n_inputs)]
    env = fused_program.eval_fused_ops(program, env,
                                       plane_divmod=g.plane_divmod)
    for t, vid in enumerate(program.outputs):
        for j, s in enumerate(env[vid]):
            g.store(t, j, s)
    return g.stmts, g.n_ops


def _operand(v) -> str:
    return v if isinstance(v, str) else f"0x{v:08x}u"


def _render_block(stmts, width: int, indent: str) -> list[str]:
    out = []
    for st in stmts:
        kind = st[0]
        if kind == "load":
            _, dst, i, j = st
            out.append(f"const uint32_t {dst} = "
                       f"__ldg(xp + {i * width + j}LL * n);")
        elif kind == "op":
            dst, op, *args = st[1:]
            expr = (f"~{_operand(args[0])}" if op == "~" else
                    f"{_operand(args[0])} {op} {_operand(args[1])}")
            out.append(f"const uint32_t {dst} = {expr};")
        elif kind == "store":
            _, t, j, src = st
            out.append(f"op[{t * width + j}LL * n] = {_operand(src)};")
        elif kind == "array":
            _, name, srcs = st
            out.append(f"uint32_t {name}[{len(srcs)}] = "
                       f"{{{', '.join(_operand(s) for s in srcs)}}};")
        elif kind == "zeros":
            out.append(f"uint32_t {st[1]}[{st[2]}];")
        elif kind == "var":
            out.append(f"uint32_t {st[1]} = 0u;")
        elif kind == "loop":
            _, n, body = st
            out.append("#pragma unroll 1")
            out.append(f"for (int i = {n - 1}; i >= 0; --i) {{")
            out.extend(_render_block(body, width, "  "))
            out.append("}")
        elif kind == "index":
            out.append(f"const uint32_t {st[1]} = {st[2]}[i];")
        elif kind == "store_i":
            out.append(f"{st[1]}[i] = {_operand(st[2])};")
        elif kind == "mov":
            out.append(f"const uint32_t {st[1]} = {st[2]};")
        elif kind == "assign":
            out.append(f"{st[1]} = {_operand(st[2])};")
        elif kind == "read":
            out.append(f"const uint32_t {st[1]} = {st[2]}[{st[3]}];")
        else:
            raise ValueError(f"unknown IR statement {kind!r}")
    return [indent + line if not line.startswith("#") else line
            for line in out]


_KERNEL = """\
// Fused-program kernel generated by repro_torch/kernels/codegen.py.
// program: {program}
// {n_ops} logic ops per word column.
#include <cstdint>
#include <cuda_runtime.h>

extern "C" __global__ void __launch_bounds__({block})
fused_program_kernel(const uint32_t* __restrict__ x,
                     uint32_t* __restrict__ out, long long n) {{
  const long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= n) return;
  const uint32_t* __restrict__ xp = x + w;
  uint32_t* __restrict__ op = out + w;
{body}
}}

extern "C" int fused_program_launch(const void* x, void* out, long long n,
                                    void* stream) {{
  if (n > 0) {{
    const long long blocks = (n + {block} - 1) / {block};
    fused_program_kernel<<<(unsigned)blocks, {block}, 0,
                           (cudaStream_t)stream>>>(
        (const uint32_t*)x, (uint32_t*)out, n);
  }}
  return (int)cudaGetLastError();
}}

extern "C" const char* error_string(int code) {{
  return cudaGetErrorString((cudaError_t)code);
}}
"""


def render(program) -> str:
    """The CUDA C source of ``program``'s kernel (deterministic)."""
    stmts, n_ops = generate(program)
    body = "\n".join(_render_block(stmts, program.width, "  "))
    return _KERNEL.format(program=repr(program), n_ops=n_ops, body=body,
                          block=BLOCK)


@functools.lru_cache(maxsize=1)
def _generator_text() -> str:
    return "".join(p.read_text() for p in _GENERATOR_SOURCES)


@functools.lru_cache(maxsize=256)
def build_item(program) -> tuple[str, str]:
    """``(library name, source)`` for ``program``: the name hashes the
    program and the generator's own sources."""
    return (_build.source_name("fused_program", repr(program),
                               _generator_text()),
            render(program))


def launch(program, x: torch.Tensor) -> torch.Tensor:
    """Run ``program``'s kernel on ``x``: contiguous ``[n_inputs, width,
    W]`` int32 CUDA planes -> ``[n_outputs, width, W]``."""
    if not x.is_cuda:
        raise ValueError("run_program_cuda takes a CUDA tensor")
    if x.dtype != torch.int32 or x.dim() != 3 \
            or tuple(x.shape[:2]) != (program.n_inputs, program.width):
        raise ValueError(
            f"expected [{program.n_inputs}, {program.width}, W] int32 "
            f"planes, got {tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("run_program_cuda takes a contiguous tensor")
    n = x.shape[2]
    out = x.new_empty((len(program.outputs), program.width, n))
    name, src = build_item(program)
    lib = _build.load(name, src, "fused_program_launch")
    with torch.cuda.device(x.device):
        rc = lib.fused_program_launch(x.data_ptr(), out.data_ptr(), n,
                                      _build.stream_of(x))
    _build.check(lib, rc, NAME)
    if n:
        _build.LAUNCHES[NAME] += 1
    return out
