"""Fused bit-plane program compiler: one pipeline for a whole op graph.

The port's copy of ``repro.kernels.fused_program``. A recorded op sequence
(:class:`FusedProgram`) compiles into one pipeline that

  1. transposes each operand horizontal -> vertical ONCE (bit-transpose
     kernel),
  2. evaluates the whole program on bit-planes in one kernel launch with
     every intermediate in registers (the fused-program kernel),
  3. transposes the requested outputs back ONCE.

The same program IR runs in these evaluators, all bit-exact against each
other and against the reference:

  * ``run_program_cuda`` — the fused-program CUDA kernel, generated per
    program structure (``kernels/codegen.py``): one thread per word
    column, the straight-line program in registers;
  * ``run_program_ref`` — its plain version (the vertical torch oracle);
  * ``run_program_words`` — the horizontal word-domain evaluator, the CPU
    execution path: the bracketing transposes cancel algebraically, so
    the program runs directly on int32 words; 64-bit lanes run as
    (lo, hi) uint32 halves held in int64 (``run_program_pairs``).

Values are unsigned width-bit integers carried bit-for-bit in int32 lanes;
every opcode computes modulo ``2**width``. Opcodes: and/or/xor
(plane-wise), add/sub (ripple carry/borrow), mul (shift-add), div/mod
(restoring division; lanes dividing by zero yield 0), divmod (tuple value
consumed by fst/snd), less (unsigned compare -> 0/1), popcount (adder
tree), reduce_and(param=w) (== mask(w)), reduce_or (!= 0), reduce_xor
(parity).

Backend selection goes through :mod:`repro_torch.backends` (capability
``"fused"``) for the device the leaves live on: ``vertical-cuda`` on a
CUDA device, ``words-torch`` on the CPU, ``ref-vertical`` and
``shard-words`` (the word axis split across devices) by name.
Programs are frozen/hashable, so pipelines are cached on graph structure.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.backends import get_backend, select_backend
from repro_torch.kernels import ref
from repro_torch.kernels.plane_layout import LAYOUT32, PlaneLayout
from repro_torch.kernels.ref import s32

OPCODES = ("and", "or", "xor", "add", "sub", "mul", "div", "mod", "divmod",
           "fst", "snd", "less", "popcount", "reduce_and", "reduce_or",
           "reduce_xor")

# Opcodes whose operand order does not matter: CSE canonicalizes their
# argument tuples by sorting so `add(a, b)` and `add(b, a)` unify.
COMMUTATIVE = frozenset({"and", "or", "xor", "add", "mul"})

_M32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class FusedOp:
    """One instruction: ``args`` are value ids in the program's combined id
    space (leaf inputs 0..n_inputs-1, then op results in program order)."""
    opcode: str
    args: tuple[int, ...]
    param: int = 0  # reduce_and: the eager path's mask width w


@dataclasses.dataclass(frozen=True)
class FusedProgram:
    """A straight-line bit-plane program (hashable == pipeline cache key).

    Value-id space: leaf inputs occupy ids ``0..n_inputs-1``; op ``i``'s
    result is id ``n_inputs + i``. ``outputs`` lists the value ids to
    materialize. ``layout`` names the lane word format the pipeline
    evaluates in (and is part of the cache key).
    """
    width: int
    n_inputs: int
    ops: tuple[FusedOp, ...]
    outputs: tuple[int, ...]  # value ids to materialize
    layout: PlaneLayout = LAYOUT32


def optimize_program(program: FusedProgram
                     ) -> tuple[FusedProgram, tuple[int, ...],
                                tuple[int, ...]]:
    """Common-subexpression elimination + dead-node/leaf pruning.

    Returns ``(optimized, out_pos, leaf_map)``:

    * ``optimized`` — the normalized program (commutative args sorted,
      duplicate ops unified, unreferenced ops and leaves dropped, ids
      renumbered densely), still a valid pipeline cache key;
    * ``out_pos`` — for each entry of ``program.outputs``, the index into
      ``optimized.outputs`` holding its value;
    * ``leaf_map`` — original leaf ids still used, in the order the
      optimized program expects its inputs.

    >>> p = FusedProgram(width=8, n_inputs=2, ops=(
    ...     FusedOp("add", (0, 1)), FusedOp("add", (1, 0)),
    ...     FusedOp("xor", (2, 3)), FusedOp("and", (0, 0))), outputs=(4,))
    >>> opt, out_pos, leaf_map = optimize_program(p)
    >>> len(opt.ops), opt.ops[1].args, out_pos, leaf_map
    (2, (2, 2), (0,), (0, 1))
    """
    return _optimize_cached(program)


@functools.lru_cache(maxsize=512)
def _optimize_cached(program: FusedProgram):
    n_in = program.n_inputs
    canon: dict[int, int] = {}     # original op id -> canonical value id
    table: dict[tuple, int] = {}   # (opcode, args, param) -> value id
    kept: list[tuple[int, FusedOp]] = []
    for i, op in enumerate(program.ops):
        vid = n_in + i
        args = tuple(canon.get(a, a) for a in op.args)
        if op.opcode in COMMUTATIVE:
            args = tuple(sorted(args))
        key = (op.opcode, args, op.param)
        prev = table.get(key)
        if prev is not None:
            canon[vid] = prev
        else:
            table[key] = canon[vid] = vid
            kept.append((vid, FusedOp(op.opcode, args, op.param)))
    out_canon = [canon.get(v, v) for v in program.outputs]
    # Narrow each divmod consumed by only one kind of selector into the
    # direct div / mod op (after unification, so `a // b; a % b` pairs
    # stay on one divider pass); the orphaned pair falls to the liveness
    # prune below.
    users: dict[int, set] = {}
    for _, op in kept:
        for a in op.args:
            users.setdefault(a, set()).add(op.opcode)
    out_set = set(out_canon)
    pair_args = {vid: op.args for vid, op in kept
                 if op.opcode == "divmod" and vid not in out_set
                 and users.get(vid) in ({"fst"}, {"snd"})}
    if pair_args:
        kept = [(vid, FusedOp("div" if op.opcode == "fst" else "mod",
                              pair_args[op.args[0]]))
                if op.opcode in ("fst", "snd") and op.args[0] in pair_args
                else (vid, op)
                for vid, op in kept]
    needed = set(out_canon)
    for vid, op in reversed(kept):  # backward liveness from the outputs
        if vid in needed:
            needed.update(op.args)
    live = [(vid, op) for vid, op in kept if vid in needed]
    leaf_map = tuple(sorted(v for v in needed if v < n_in))
    remap = {old: new for new, old in enumerate(leaf_map)}
    for j, (vid, _) in enumerate(live):
        remap[vid] = len(leaf_map) + j
    ops = tuple(FusedOp(op.opcode, tuple(remap[a] for a in op.args),
                        op.param) for _, op in live)
    outputs: list[int] = []
    pos_of: dict[int, int] = {}
    out_pos = []
    for v in out_canon:
        rv = remap[v]
        if rv not in pos_of:
            pos_of[rv] = len(outputs)
            outputs.append(rv)
        out_pos.append(pos_of[rv])
    opt = FusedProgram(width=program.width, n_inputs=len(leaf_map),
                       ops=ops, outputs=tuple(outputs),
                       layout=program.layout)
    return opt, tuple(out_pos), leaf_map


# --------------------------------------------------------------------- #
# Vertical evaluator (plain version of the fused-program kernel; the
# code generator traces the same functions over symbolic planes)
# --------------------------------------------------------------------- #


def eval_fused_ops(program: FusedProgram, env: list,
                   plane_divmod=ref.plane_divmod) -> list:
    """Evaluate ``program`` over ``env`` (list of plane-list values, leaves
    first), appending one value per op. Uses only ``& | ^ ~`` on the
    planes, so it runs on int32 tensors and on the code generator's
    symbolic planes alike; ``plane_divmod`` lets the generator emit the
    divider as a loop."""
    zero = env[0][0] ^ env[0][0]
    for op in program.ops:
        xs = [env[a] for a in op.args]
        env.append(_apply_op(op, xs, program.width, zero, plane_divmod))
    return env


def _apply_op(op: FusedOp, xs: list, width: int, zero, plane_divmod):
    def scalar(plane):  # 0/1 result plane -> width-plane value
        return [plane] + [zero] * (width - 1)

    if op.opcode == "and":
        return [a & b for a, b in zip(xs[0], xs[1])]
    if op.opcode == "or":
        return [a | b for a, b in zip(xs[0], xs[1])]
    if op.opcode == "xor":
        return [a ^ b for a, b in zip(xs[0], xs[1])]
    if op.opcode == "add":
        return ref.plane_add(xs[0], xs[1])
    if op.opcode == "sub":
        return ref.plane_sub(xs[0], xs[1])[0]
    if op.opcode == "mul":
        return ref.plane_mul(xs[0], xs[1])
    if op.opcode in ("div", "mod"):
        q, r = plane_divmod(xs[0], xs[1])
        return q if op.opcode == "div" else r
    if op.opcode == "divmod":
        return plane_divmod(xs[0], xs[1])  # tuple value: one divider
    if op.opcode == "fst":
        return xs[0][0]
    if op.opcode == "snd":
        return xs[0][1]
    if op.opcode == "less":
        return scalar(ref.plane_sub(xs[0], xs[1])[1])
    if op.opcode == "popcount":
        counts = ref.plane_popcount(xs[0])
        return (counts + [zero] * width)[:width]
    if op.opcode == "reduce_and":
        # Eager semantics: value == mask(w). Bits below w must all be set,
        # bits at/above w must all be clear (values are width-bit).
        w = min(op.param or width, width)
        if op.param and op.param > width:
            return scalar(zero)  # mask(w) > any width-bit value
        low = ref.plane_reduce(xs[0][:w], "and")
        if w < width:
            low = low & ~ref.plane_reduce(xs[0][w:], "or")
        return scalar(low)
    if op.opcode == "reduce_or":
        return scalar(ref.plane_reduce(xs[0], "or"))
    if op.opcode == "reduce_xor":
        return scalar(ref.plane_reduce(xs[0], "xor"))
    raise KeyError(op.opcode)


def run_program_ref(program: FusedProgram, x: torch.Tensor) -> torch.Tensor:
    """x: [n_inputs, width, W] int32 plane stacks -> [n_out, width, W]."""
    env = [[x[i, j] for j in range(program.width)]
           for i in range(program.n_inputs)]
    env = eval_fused_ops(program, env)
    return torch.stack([torch.stack(env[v]) for v in program.outputs])


def run_program_cuda(program: FusedProgram, x: torch.Tensor) -> torch.Tensor:
    """The fused-program kernel: same ``[n_in, width, W] -> [n_out,
    width, W]`` contract as :func:`run_program_ref`, on a CUDA tensor."""
    from repro_torch.kernels import codegen
    return codegen.launch(program, x)


# --------------------------------------------------------------------- #
# Horizontal word-domain evaluator (CPU execution path)
# --------------------------------------------------------------------- #


def _narrow(v: torch.Tensor) -> torch.Tensor:
    """int64 holding uint32 values -> int32 with the same bits."""
    return ((v ^ (1 << 31)) - (1 << 31)).to(torch.int32)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of 32-bit words (Hacker's Delight 5-2) held in int32
    or int64 lanes: each right shift is masked, so the sign fill of an
    arithmetic shift never reaches the count."""
    m1, m2, m4, h01 = LAYOUT32.swar_consts
    x = x - ((x >> 1) & m1)
    x = (x & m2) + ((x >> 2) & m2)
    x = (x + (x >> 4)) & m4
    return (x * h01 >> 24) & 0xFF


def _apply_word_op(op: FusedOp, xs: list, width: int, mask):
    """One opcode on int32 lanes carrying uint32 words."""
    def trunc(v):  # modulo 2**width; free when width fills the word
        return v if mask is None else v & mask

    if op.opcode == "and":
        return xs[0] & xs[1]
    if op.opcode == "or":
        return xs[0] | xs[1]
    if op.opcode == "xor":
        return xs[0] ^ xs[1]
    if op.opcode == "add":
        return trunc(xs[0] + xs[1])
    if op.opcode == "sub":
        return trunc(xs[0] - xs[1])
    if op.opcode == "mul":
        return trunc(xs[0] * xs[1])
    if op.opcode in ("div", "mod", "divmod"):
        # Unsigned semantics widen to int64; x // 0 == x % 0 == 0 per lane.
        a = xs[0].to(torch.int64) & _M32
        b = xs[1].to(torch.int64) & _M32
        zero_div = b == 0
        safe = torch.where(zero_div, torch.ones_like(b), b)
        q = a // safe
        r = a - q * safe
        q = _narrow(torch.where(zero_div, torch.zeros_like(q), q))
        r = _narrow(torch.where(zero_div, torch.zeros_like(r), r))
        return q if op.opcode == "div" else r if op.opcode == "mod" \
            else (q, r)
    if op.opcode == "fst":
        return xs[0][0]
    if op.opcode == "snd":
        return xs[0][1]
    if op.opcode == "less":
        # Unsigned compare: flipping the sign bit maps uint32 order onto
        # int32 order.
        flip = s32(1 << 31)
        return ((xs[0] ^ flip) < (xs[1] ^ flip)).to(torch.int32)
    if op.opcode == "popcount":
        return popcount32(xs[0])
    if op.opcode == "reduce_and":
        w = op.param or width
        if w > 32:  # mask(w) exceeds any width-bit value
            return torch.zeros_like(xs[0])
        return (xs[0] == s32(LAYOUT32.mask(w))).to(torch.int32)
    if op.opcode == "reduce_or":
        return (xs[0] != 0).to(torch.int32)
    if op.opcode == "reduce_xor":
        return popcount32(xs[0]) & 1
    raise KeyError(op.opcode)


def run_program_words(program: FusedProgram, leaves: list) -> tuple:
    """32-bit lanes, horizontal layout: leaves are flat int32 wire tensors
    (element i = word i), returns one int32 tensor per program output.
    Operands are masked to ``width`` bits on entry — identical value
    semantics to the vertical evaluators."""
    if program.layout.word_bits != 32:
        return run_program_pairs(program, leaves)
    mask = None if program.width == 32 else LAYOUT32.mask(program.width)
    env = list(leaves) if mask is None else [x & mask for x in leaves]
    for op in program.ops:
        env.append(_apply_word_op(op, [env[a] for a in op.args],
                                  program.width, mask))
    return tuple(env[v] for v in program.outputs)


# --------------------------------------------------------------------- #
# 64-bit lanes: (lo, hi) uint32 halves held in int64
# --------------------------------------------------------------------- #


def _pair_divmod(a, b):
    """Unsigned 64-bit divmod on (lo, hi) halves: MSB-first restoring
    division, one quotient bit per step. The partial remainder keeps its
    shifted-out top bit, so ``rem >= b`` is exact even when the shifted
    remainder passes 2^64. Lanes dividing by zero yield (0, 0)."""
    alo, ahi = a
    blo, bhi = b
    zero = torch.zeros_like(alo)
    rlo, rhi, qlo, qhi = zero, zero, zero, zero
    for i in reversed(range(64)):
        top = rhi >> 31
        rhi = ((rhi << 1) | (rlo >> 31)) & _M32
        abit = (ahi >> (i - 32)) & 1 if i >= 32 else (alo >> i) & 1
        rlo = ((rlo << 1) | abit) & _M32
        ge = (top == 1) | (rhi > bhi) | ((rhi == bhi) & (rlo >= blo))
        d = rlo - blo
        nhi = (rhi - bhi - (d < 0).to(torch.int64)) & _M32
        rlo = torch.where(ge, d & _M32, rlo)
        rhi = torch.where(ge, nhi, rhi)
        bit = ge.to(torch.int64)
        if i >= 32:
            qhi = qhi | (bit << (i - 32))
        else:
            qlo = qlo | (bit << i)
    bz = (blo | bhi) == 0
    return ((torch.where(bz, zero, qlo), torch.where(bz, zero, qhi)),
            (torch.where(bz, zero, rlo), torch.where(bz, zero, rhi)))


def _apply_pair_op(op: FusedOp, xs: list, width: int, mask):
    """One opcode on (lo, hi) pair values — the 64-bit-lane mirror of
    ``_apply_word_op`` (identical value semantics, pinned by tests)."""
    def trunc(lo, hi):  # modulo 2**width; free at the natural word
        return (lo, hi) if mask is None else (lo & mask[0], hi & mask[1])

    if op.opcode == "and":
        return (xs[0][0] & xs[1][0], xs[0][1] & xs[1][1])
    if op.opcode == "or":
        return (xs[0][0] | xs[1][0], xs[0][1] | xs[1][1])
    if op.opcode == "xor":
        return (xs[0][0] ^ xs[1][0], xs[0][1] ^ xs[1][1])
    if op.opcode == "add":
        (alo, ahi), (blo, bhi) = xs[0], xs[1]
        s = alo + blo
        return trunc(s & _M32, (ahi + bhi + (s >> 32)) & _M32)
    if op.opcode == "sub":
        (alo, ahi), (blo, bhi) = xs[0], xs[1]
        d = alo - blo
        return trunc(d & _M32,
                     (ahi - bhi - (d < 0).to(torch.int64)) & _M32)
    if op.opcode == "mul":
        # int64 products wrap modulo 2^64, which keeps every bit below 64.
        (alo, ahi), (blo, bhi) = xs[0], xs[1]
        p = alo * blo
        return trunc(p & _M32, ((p >> 32) + alo * bhi + ahi * blo) & _M32)
    if op.opcode in ("div", "mod", "divmod"):
        q, r = _pair_divmod(xs[0], xs[1])
        return q if op.opcode == "div" else r if op.opcode == "mod" \
            else (q, r)
    if op.opcode == "fst":
        return xs[0][0]
    if op.opcode == "snd":
        return xs[0][1]
    zero = torch.zeros_like(xs[0][0])
    if op.opcode == "less":
        (alo, ahi), (blo, bhi) = xs[0], xs[1]
        lt = (ahi < bhi) | ((ahi == bhi) & (alo < blo))
        return (lt.to(torch.int64), zero)
    if op.opcode == "popcount":
        lo, hi = xs[0]
        return (popcount32(lo) + popcount32(hi), zero)
    if op.opcode == "reduce_and":
        w = op.param or width
        if w > 64:  # mask(w) exceeds any width-bit value
            return (zero, zero)
        lo, hi = xs[0]
        mlo = (1 << min(w, 32)) - 1
        mhi = 0 if w <= 32 else (1 << (w - 32)) - 1
        return (((lo == mlo) & (hi == mhi)).to(torch.int64), zero)
    if op.opcode == "reduce_or":
        lo, hi = xs[0]
        return (((lo | hi) != 0).to(torch.int64), zero)
    if op.opcode == "reduce_xor":
        lo, hi = xs[0]
        return (popcount32(lo ^ hi) & 1, zero)
    raise KeyError(op.opcode)


def run_program_pairs(program: FusedProgram, leaves: list) -> tuple:
    """The 64-bit lane path: each flat int32 wire leaf (lo, hi interleaved
    little-endian) splits into uint32 halves held in int64, the whole
    program evaluates on pairs with carries chained across the pair, and
    outputs re-interleave to int32 wire."""
    width = program.width
    mask = None
    if width < 64:
        mask = ((1 << min(width, 32)) - 1,
                0 if width <= 32 else (1 << (width - 32)) - 1)
    env = []
    for w in leaves:
        v = w.reshape(-1, 2).to(torch.int64) & _M32
        lo, hi = v[:, 0], v[:, 1]
        env.append((lo, hi) if mask is None
                   else (lo & mask[0], hi & mask[1]))
    for op in program.ops:
        env.append(_apply_pair_op(op, [env[a] for a in op.args],
                                  width, mask))
    return tuple(_narrow(torch.stack(env[v], dim=1).reshape(-1))
                 for v in program.outputs)


# --------------------------------------------------------------------- #
# End-to-end pipeline: pack -> run -> unpack, cached on structure.
# Evaluator chosen by capability lookup in the repro_torch.backends
# registry for the device the leaves live on.
# --------------------------------------------------------------------- #


def get_pipeline(program: FusedProgram, device="cuda", donate: bool = False,
                 backend: str | None = None):
    """Callable for ``program``: ``fn(*leaves) -> tuple(outs)``.

    Leaves are flat int32 *wire* tensors of packed horizontal words
    (``program.layout.wire_words_per_lane`` words per lane, lane count a
    multiple of 32) on ``device``; outputs likewise. ``backend=`` names a
    registered evaluator explicitly; otherwise the registry picks the best
    one available on ``device``. Cached on (program structure, backend,
    donate)."""
    wb = program.layout.word_bits
    if backend is None:
        backend = select_backend(require="fused", device=device,
                                 width=program.width,
                                 layout=program.layout).name
    spec = get_backend(backend)
    if wb not in spec.layouts:
        raise ValueError(
            f"backend {backend!r} does not support the {wb}-bit plane "
            f"layout (declares {sorted(spec.layouts)})")
    # Cache on the resolved BackendSpec, not the name. Every registration
    # gets a fresh default ``available`` function, so a re-registered
    # spec never equals the old one even with the same builder and knobs,
    # and the cache builds its pipeline anew.
    return _cached_pipeline(program, spec, donate)


@functools.lru_cache(maxsize=256)  # bounded: one pipeline per structure
def _cached_pipeline(program: FusedProgram, spec, donate: bool):
    return spec.builder(program, donate=donate)


def with_fault_injection(pipeline, injector):
    """Fault-injection hook over a compiled pipeline.

    ``injector(outs) -> outs`` receives the tuple of clean wire outputs
    after each execution and returns the outputs to hand to the caller —
    the reliability plane (``repro_torch.reliability``) derives
    fault-injected replicas from the clean run, majority-votes them and
    retries on weak margins. The wrapper is built per flush only when
    injection is enabled, so the disabled path calls the cached pipeline
    directly and the cached pipeline stays the same object.
    """
    def injected(*leaves):
        return injector(pipeline(*leaves))

    return injected


def build_words_pipeline(program: FusedProgram, donate: bool = False):
    """Word-domain pipeline (the CPU execution path): the bracketing
    transpose pair cancels algebraically, so the program runs directly on
    horizontal words — int32 lanes at the 32-bit layout, (lo, hi) halves
    at the 64-bit one."""
    def word_pipeline(*leaves):
        return run_program_words(program, list(leaves))

    # Leaf-cache protocol (engine._resolve_cached_leaves): cached device
    # buffers are served unless the flush donates its leaves.
    word_pipeline.wants_device = lambda wire_words: not donate
    return word_pipeline


def build_sharded_words_pipeline(program: FusedProgram,
                                 donate: bool = False, mesh=None):
    """Multi-device pipeline (``shard-words``): the program's word axis
    splits into contiguous shards, one per device of a ``("words",)``
    mesh, so ONE flush executes one program on every device. The program
    is elementwise across words, so the split needs no communication:
    each shard is copied to its device, runs there, and the outputs are
    gathered back onto the leaves' device and sliced to their length.

    ``mesh`` (a :func:`~repro_torch.distributed.sharding.words_mesh`)
    names the devices; by default CUDA leaves shard over every visible
    card and CPU leaves stay whole on their device. Leaves pad to a
    multiple of 32 x n_devices words first. Each shard runs the evaluator
    its device selects (``backends.shard_backend``): on a card that is
    ``vertical-cuda`` (K1 on each leaf and output, K2 once), on the CPU
    ``words-torch``. The reference evaluates every shard in the word
    domain; the outputs, and the cost plane's ``EngineStats``, are the
    same. Every shard is launched before any output is gathered:
    launches on different cards are asynchronous, and waiting on one
    card before launching the next would serialise them. ``donate`` is
    ignored, as in the reference: donated leaves would alias the shards.
    """
    from repro_torch.backends import shard_backend
    from repro_torch.distributed.sharding import words_mesh

    if program.layout.word_bits != 32:
        raise ValueError("shard-words shards the 32-bit word layout; "
                         "register a 64-bit variant to widen it")

    def devices_for(leaf: torch.Tensor) -> tuple:
        if mesh is not None:
            return mesh.devices
        if leaf.is_cuda:
            return words_mesh().devices
        return (leaf.device,)

    def sharded_pipeline(*leaves):
        home = leaves[0].device
        devices = devices_for(leaves[0])
        n = leaves[0].shape[0]
        pad = (-n) % (32 * len(devices))
        per = (n + pad) // len(devices)
        padded = [torch.nn.functional.pad(x, (0, pad)) for x in leaves]
        shard_outs = []
        for i, dev in enumerate(devices):
            spec = shard_backend(dev, program.width, program.layout)
            run = get_pipeline(program, device=dev, backend=spec.name)
            shard_outs.append(run(*(
                x[i * per:(i + 1) * per].to(dev, non_blocking=True)
                for x in padded)))
        # A copy to the host is never asynchronous: it is read at once.
        async_home = home.type == "cuda"
        return tuple(
            torch.cat([outs[t].to(home, non_blocking=async_home)
                       for outs in shard_outs])[:n]
            for t in range(len(program.outputs)))

    # Leaf-cache protocol: no evaluator writes its inputs, so cached
    # device buffers are safe to serve (a donating engine never offers
    # them).
    sharded_pipeline.wants_device = lambda wire_words: True
    return sharded_pipeline


def build_vertical_pipeline(program: FusedProgram, use_kernels: bool,
                            donate: bool = False):
    """Vertical bit-plane pipeline: transpose in once, run the fused
    program, transpose out once. ``use_kernels`` routes both steps through
    the kernel wrappers of :mod:`repro_torch.kernels.ops` (the CUDA
    kernels on CUDA tensors); otherwise it runs their plain versions. A
    64-bit lane is two stacked 32x32 transpose tiles, so the one transpose
    kernel serves every layout."""
    width = program.width
    layout = program.layout
    if use_kernels:
        from repro_torch.kernels import ops
        transpose = ops.bit_transpose32
        run = functools.partial(ops.run_fused_program, program)
    else:
        transpose = ref.bit_transpose32
        run = functools.partial(run_program_ref, program)

    def vertical_pipeline(*leaves):
        stack = torch.stack([layout.pack_planes(leaf, transpose, width)
                             for leaf in leaves])
        outs = run(stack)
        return tuple(layout.unpack_planes(outs[t], transpose, width)
                     for t in range(outs.shape[0]))

    vertical_pipeline.wants_device = lambda wire_words: not donate
    return vertical_pipeline
