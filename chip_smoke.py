"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a host with one CUDA card and the CUDA
toolkit (``nvcc`` under ``$CUDA_HOME``, default ``/usr/local/cuda``). It
builds the port's hand-written kernels from ``src/repro_torch/kernels``
into ``build/repro_torch/`` and then, failing on the first error:

1. prints the card (``nvidia-smi``) and the kernels' build times;
2. holds the bit-transpose kernel against its plain PyTorch version on
   the card, bit-exact, at G = 65536 tiles (2M lanes) and G = 1000, and
   times both;
3. holds the fused-program kernel against its plain version, bit-exact,
   on random programs over all 16 opcodes at widths 8/16/32/33/64 and on
   the prog16 staple at 2M lanes, and times it beside the word-domain
   pipeline on the same program (the yardstick; the port never calls it
   on the card's path);
4. holds the charge-sharing kernel against its plain version (rtol 1e-5,
   atol 1e-7 V) at v [12, N, 65536] for N = 4, 8, 16, 32 and at ragged
   shapes, and the MAJ-N kernel bit-exact at N = 3, 5, 7, 32 over every
   threshold at W = 1001, 65536 and 2M words; times both (raw launches
   rotating buffers past the L2 cache) beside their plain versions;
5. drives the main path through the public entry point
   ``repro_torch.pum.device(width=...)`` (default device ``cuda``):
   prog16 at 2M and 32M lanes, mulprog16 at width 16, a width-64 program
   (two transpose tiles per lane) and a 30-bitmap AND + popcount (the
   fig20 BMI scale, raw packed-bitmap mode), each bit-exact against the
   port's eager host path with identical ``EngineStats``, on the
   ``vertical-cuda`` backend, with both kernels' launch counts rising;
6. checks the paper's analog anchors on ``MonteCarloDb`` at the
   reference's default sizes (2048 bitlines, 24 groups, 48 patterns) on
   the card;
7. the reliability path: a full-size calibration of the default
   ``EngineConfig`` chip (mfr M, 16 banks x 8 subarrays x 65536 columns,
   12 patterns) on the charge-sharing kernel (wall time, launches, success
   per config), then that map attached with ``inject=True`` to prog16 at
   2M lanes and to the width-64 program: outputs bit-exact against a
   non-injecting device, every ``reliability.*`` counter equal to the same
   injected flush run on the CPU, faults injected and corrected, and the
   transpose, fused-program and MAJ-N kernels all launching;
8. prints one JSON line of per-kernel results, the card's name and power
   limit, and last ``{"ok": true, "device": {...}}``.

It exits non-zero, printing no result, when CUDA is unavailable or the
rest of the repository is missing. All data is made from fixed seeds.
"""

from __future__ import annotations

import collections
import itertools
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
ALU_OPS_PER_S = 67e12       # H100 SXM 32-bit non-tensor peak
FP32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
SEED = 20231202


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip()


def cuda_ms(fn, calls: int, rounds: int = 5, warmup: int = 2) -> float:
    """Milliseconds per call of ``fn``: CUDA events around ``calls``
    back-to-back calls on the current stream, divided by ``calls``; the
    median of ``rounds`` such runs, after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def cycle_launch(lib, entry: str, arg_tuples):
    """A zero-argument call of a kernel library's C launch entry, cycling
    over argument tuples: the kernel's own time, without the wrapper's
    Python checks (which cost more than the kernel at these sizes). The
    buffers of the tuples together exceed the card's 50 MB L2 cache, so
    each launch reads its input from device memory, as the caller does."""
    from repro_torch.kernels import _build
    fn = getattr(lib, entry)
    args = itertools.cycle(arg_tuples)

    def launch():
        _build.check(lib, fn(*next(args)), entry)
    return launch


def raw_launch(lib, entry: str, pairs, n: int):
    """:func:`cycle_launch` over ``(input, output)`` tensor pairs of an
    ``int entry(in, out, n, stream)`` kernel."""
    from repro_torch.kernels import _build
    return cycle_launch(lib, entry, [(x.data_ptr(), out.data_ptr(), n,
                                      _build.stream_of(x))
                                     for x, out in pairs])


def rotation(make, bytes_each: int, total: int = 128 << 20) -> list:
    """Enough ``make()`` results to cover ``total`` bytes (at least 2)."""
    return [make() for _ in range(max(2, -(-total // bytes_each)))]


def max_abs_err(a, b) -> int:
    """Largest |a - b| over two integer tensors (0 when bit-exact)."""
    return int((a.long() - b.long()).abs().max().item())


def dense_words(rng, n: int):
    """n uint64 bitmap words with bits set at probability 15/16 (the OR of
    four uniform words), so an AND over 30 of them keeps ~14% of bits."""
    import numpy as np
    out = np.zeros(n, np.uint64)
    for _ in range(4):
        out |= rng.integers(0, 2**64 - 1, n, dtype=np.uint64, endpoint=True)
    return out


# --------------------------------------------------------------------- #
# Workloads (the repository's staples, written against repro_torch.pum)
# --------------------------------------------------------------------- #


def prog16(dev, a, b, c):
    """16 ops over three operands: the fused-pipeline staple of
    ``benchmarks/kernel_bench.py``."""
    a = dev.asarray(a)
    t = a & b
    t = t ^ c
    t = t | b
    t = t + a
    t = t - c
    t = t ^ b
    t = t & a
    t = t + c
    t = t | a
    t = t - b
    t = t ^ a
    t = t & c
    t = t + b
    t = t.popcount()
    t = t + a
    t = t ^ c
    return t


def mulprog16(dev, a, b, c):
    """16 ops centred on mul/div/mod (``benchmarks/kernel_bench.py``)."""
    a = dev.asarray(a)
    t = a * b
    t = t + c
    t = t * a
    t = t - b
    t = t // c
    t = t ^ a
    t = t * c
    t = t | b
    t = t % a
    t = t + b
    t = t * t
    t = t & c
    t = t // b
    t = t + a
    t = t * b
    t = t ^ c
    return t


def wide64(dev, a, b, c):
    """Width-64 lanes (two transpose tiles each): add, xor, unsigned
    compare and popcount."""
    a = dev.asarray(a)
    t = a + b
    t = t ^ c
    lt = t < a
    p = t.popcount()
    return (t + p) ^ lt


def bmi(dev, bitmaps):
    """fig20 BMI: users active on every day = AND over the daily bitmaps,
    counted per word (raw packed-bitmap mode)."""
    acc = dev.asarray(bitmaps[0])
    for bm in bitmaps[1:]:
        acc = acc & bm
    return acc.popcount()


def random_program(rng, width: int, opcodes, n_inputs: int = 3):
    """Plain-tuple program using every opcode once in a seeded order."""
    ops, values = [], list(range(n_inputs))

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
            for s in (("fst", "snd") if opc == "divmod" else (opc,)):
                values.append(add(s, (pair,)))
        elif opc in ("popcount", "reduce_and", "reduce_or", "reduce_xor"):
            param = int(rng.choice([0, width // 2 + 1, width + 3])) \
                if opc == "reduce_and" else 0
            values.append(add(opc, (pick(),), param))
        else:
            values.append(add(opc, (pick(), pick())))
    return width, n_inputs, tuple(ops), tuple(values[n_inputs:][-4:])


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available on this host",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch.pum as pum
        from repro_torch.backends import select_backend
        from repro_torch.convert import program_from_reference
        from repro_torch.core.charact import MonteCarloDb
        from repro_torch.core.profiles import PROFILES
        from repro_torch.kernels import (_build, bit_transpose, charge_share,
                                         codegen, maj_n, ref)
        from repro_torch.kernels import fused_program as fp
        from repro_torch.reliability import FaultInjector
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e}); run "
              f"from the root of a checkout", file=sys.stderr)
        return 2

    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    cuda = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    results = {}

    # -- 1. build every kernel, all nvcc processes started together ----- #
    n_small = 1 << 10
    small = [rng.integers(0, 1 << 16, n_small, dtype=np.uint64)
             for _ in range(3)]
    w64_small = [rng.integers(0, 2**64 - 1, n_small, dtype=np.uint64,
                              endpoint=True) for _ in range(3)]
    bm_small = [rng.integers(0, 2**64 - 1, n_small, dtype=np.uint64,
                             endpoint=True) for _ in range(30)]

    def program_of(width, fn, *args):
        # The port's own recording on the CPU gives each main-path
        # program's structure (independent of lane count and device).
        dev = pum.device(width=width, device="cpu")
        fn(dev, *args).to_numpy()
        return dev.engine.last_program

    main_programs = {
        "prog16": program_of(32, prog16, *small),
        "mulprog16": program_of(16, mulprog16, *small),
        "wide64": program_of(64, wide64, *w64_small),
        "bmi": program_of(32, bmi, bm_small),
    }
    random_programs = [
        program_from_reference(*random_program(rng, w, fp.OPCODES),
                               32 if w <= 32 else 64)
        for w in (8, 16, 32, 33, 64)]
    t0 = time.perf_counter()
    _build.build_many([bit_transpose.build_item(), charge_share.build_item(),
                       maj_n.build_item()]
                      + [codegen.build_item(p) for p in
                         list(main_programs.values()) + random_programs])
    build_s = time.perf_counter() - t0
    print(f"build: {len(_build.BUILDS)} libraries in {build_s:.1f} s "
          f"(parallel nvcc)")
    for name, info in sorted(_build.BUILDS.items()):
        print(f"  {name}: {info['seconds']:.1f} s, "
              f"{_build.ptxas_summary(name)}")

    # -- 2. bit-transpose kernel vs its plain version -------------------- #
    k1_err = 0
    for g in (65536, 1000):
        x = torch.randint(-2**31, 2**31 - 1, (32, g), dtype=torch.int32,
                          device=cuda)
        got = bit_transpose.bit_transpose32_cuda(x)
        want = ref.bit_transpose32(x)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        k1_err = max(k1_err, err)
        check(err == 0, f"bit_transpose32 kernel disagrees at G={g}")
        print(f"K1 bit_transpose32 G={g}: bit-exact")
    def k1_pair():
        t = torch.randint(-2**31, 2**31 - 1, (32, 65536), dtype=torch.int32,
                          device=cuda)
        return t, torch.empty_like(t)

    k1_pairs = rotation(k1_pair, 2 * 32 * 65536 * 4)
    x = k1_pairs[0][0]
    k1_lib = _build.load(*bit_transpose.build_item(),
                         "bit_transpose32_launch")
    k1_ms = cuda_ms(raw_launch(k1_lib, "bit_transpose32_launch", k1_pairs,
                               x.shape[1]), 200)
    for xi, oi in k1_pairs:
        check(torch.equal(oi, ref.bit_transpose32(xi)),
              "bit_transpose32 kernel disagrees in the timing run")
    k1_wrap = cuda_ms(lambda: bit_transpose.bit_transpose32_cuda(x), 50)
    k1_plain = cuda_ms(lambda: ref.bit_transpose32(x), 3, rounds=3)
    k1_bytes = 2 * x.numel() * 4
    k1_bound = k1_bytes / HBM_BYTES_PER_S * 1e3
    print(f"K1 at G=65536 (2M lanes): kernel {k1_ms:.4f} ms (through "
          f"the Python wrapper {k1_wrap:.4f} ms), plain "
          f"{k1_plain:.4f} ms, bound {k1_bound:.4f} ms "
          f"({k1_bytes} bytes)")

    # -- 3. fused-program kernel vs its plain version -------------------- #
    k2_err = 0
    for prog in random_programs:
        x = torch.randint(-2**31, 2**31 - 1, (3, prog.width, 4096),
                          dtype=torch.int32, device=cuda)
        x[1, :, :256] = 0  # zero divisors
        got = fp.run_program_cuda(prog, x)
        want = fp.run_program_ref(prog, x)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        k2_err = max(k2_err, err)
        check(err == 0, f"fused-program kernel disagrees at width "
                        f"{prog.width}")
        print(f"K2 random program width {prog.width} "
              f"({len(prog.ops)} ops, all 16 opcodes): bit-exact")
    p16 = main_programs["prog16"]
    words = 65536
    x = torch.randint(-2**31, 2**31 - 1, (p16.n_inputs, 32, words),
                      dtype=torch.int32, device=cuda)
    got = fp.run_program_cuda(p16, x)
    want = fp.run_program_ref(p16, x)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    k2_err = max(k2_err, err)
    check(err == 0, "fused-program kernel disagrees on prog16")
    k2_lib_so = _build.load(*codegen.build_item(p16), "fused_program_launch")

    def k2_pair():
        t = torch.randint(-2**31, 2**31 - 1, tuple(x.shape),
                          dtype=torch.int32, device=cuda)
        return t, torch.empty_like(got)

    k2_pairs = [(x, torch.empty_like(got))] + rotation(
        k2_pair, (x.numel() + got.numel()) * 4)[1:]
    k2_ms = cuda_ms(raw_launch(k2_lib_so, "fused_program_launch", k2_pairs,
                               words), 200)
    for xi, oi in k2_pairs:
        check(torch.equal(oi, fp.run_program_ref(p16, xi)),
              "fused-program kernel disagrees in the timing run")
    k2_wrap = cuda_ms(lambda: fp.run_program_cuda(p16, x), 50)
    k2_plain = cuda_ms(lambda: fp.run_program_ref(p16, x), 2, rounds=3)
    wires = itertools.cycle(rotation(
        lambda: [torch.randint(-2**31, 2**31 - 1, (32 * words,),
                               dtype=torch.int32, device=cuda)
                 for _ in range(p16.n_inputs)],
        4 * 32 * words * (p16.n_inputs + 1)))
    words_pipe = fp.get_pipeline(p16, device=cuda, backend="words-torch")
    k2_lib = cuda_ms(lambda: words_pipe(*next(wires)), 20)
    _, n_ops = codegen.generate(p16)
    k2_bytes = 4 * words * p16.width * (p16.n_inputs + len(p16.outputs))
    k2_bound_b = k2_bytes / HBM_BYTES_PER_S * 1e3
    k2_bound_o = n_ops * words / ALU_OPS_PER_S * 1e3
    k2_bound = max(k2_bound_b, k2_bound_o)
    print(f"K2 prog16 at 2M lanes: kernel {k2_ms:.4f} ms (through the "
          f"Python wrapper {k2_wrap:.4f} ms), plain "
          f"{k2_plain:.4f} ms, words-torch pipeline {k2_lib:.4f} ms, "
          f"bound {k2_bound:.4f} ms ({k2_bytes} bytes, {n_ops} plane ops "
          f"x {words} columns)")
    k2_build = _build.BUILDS[codegen.build_item(p16)[0]]["seconds"]

    # -- 3b. charge-sharing kernel vs its plain version ------------------ #
    prof_m = PROFILES["M"]
    vdd, c_bl = prof_m.vdd, prof_m.bitline_cap_ff
    gen = torch.Generator(device=cuda).manual_seed(SEED)

    def cs_fields(p, n, b):
        shape = (n, b) if p is None else (p, n, b)
        v = (torch.rand(shape, generator=gen, device=cuda) < 0.5).float()
        v = v * vdd
        v[..., n - 1, :] = 0.5 * vdd  # a Frac-neutral row
        caps = prof_m.cell_cap_ff * (
            1 + prof_m.process_variation
            * torch.randn((n, b), generator=gen, device=cuda))
        return v, caps

    k5_err = 0.0
    for p, n, b in [(12, 4, 65536), (12, 8, 65536), (12, 16, 65536),
                    (12, 32, 65536), (5, 9, 1001), (None, 3, 777)]:
        v, caps = cs_fields(p, n, b)
        got = charge_share.charge_share_cuda(v, caps, vdd=vdd, c_bl=c_bl)
        want = ref.charge_share(v, caps, vdd=vdd, c_bl=c_bl)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        k5_err = max(k5_err, err)
        check(bool(torch.allclose(got, want, rtol=1e-5, atol=1e-7)),
              f"charge_share kernel disagrees at P={p} N={n} B={b} "
              f"(max abs err {err})")
        print(f"K5 charge_share P={p} N={n} B={b}: max abs err {err:.3g} V "
              f"(rtol 1e-5, atol 1e-7)")
    # Timed at the calibration's heaviest shape for mfr M: 12 patterns of
    # a 16-row activation over 65536 columns.
    k5_p, k5_n, k5_b = 12, 16, 65536
    k5_sets = rotation(lambda: cs_fields(k5_p, k5_n, k5_b)
                       + (torch.empty((k5_p, k5_b), device=cuda),),
                       (k5_p * k5_n * k5_b + k5_n * k5_b + k5_p * k5_b) * 4)
    k5_lib = charge_share.library()
    k5_ms = cuda_ms(cycle_launch(
        k5_lib, charge_share.ENTRY,
        [(v.data_ptr(), c.data_ptr(), o.data_ptr(), k5_p, k5_n, k5_b, vdd,
          c_bl, _build.stream_of(v)) for v, c, o in k5_sets]), 200)
    for v, c, o in k5_sets:
        check(bool(torch.allclose(o, ref.charge_share(v, c, vdd=vdd,
                                                      c_bl=c_bl),
                                  rtol=1e-5, atol=1e-7)),
              "charge_share kernel disagrees in the timing run")
    v, c, _ = k5_sets[0]
    k5_plain = cuda_ms(lambda: ref.charge_share(v, c, vdd=vdd, c_bl=c_bl),
                       20)
    k5_bytes = (k5_p * k5_n * k5_b + k5_n * k5_b + k5_p * k5_b) * 4
    k5_bound_b = k5_bytes / HBM_BYTES_PER_S * 1e3
    k5_bound_o = k5_p * k5_b * (3 * k5_n + 1) / FP32_OPS_PER_S * 1e3
    k5_bound = max(k5_bound_b, k5_bound_o)
    print(f"K5 at P={k5_p} N={k5_n} B={k5_b}: kernel {k5_ms:.4f} ms, plain "
          f"{k5_plain:.4f} ms, bound {k5_bound:.4f} ms ({k5_bytes} bytes)")

    # -- 3c. MAJ-N kernel vs its plain version --------------------------- #
    k3_err = 0
    for n in (3, 5, 7, 32):
        for w in (1001, 65536, 1 << 21):
            x = torch.randint(-2**31, 2**31 - 1, (n, w), dtype=torch.int32,
                              device=cuda)
            x[:, :7] = -1
            for t in range(1, n + 1):
                got = maj_n.maj_n_cuda(x, t)
                want = ref.maj_n_fast(x, t)
                torch.cuda.synchronize()
                err = max_abs_err(got, want)
                k3_err = max(k3_err, err)
                check(err == 0, f"maj_n kernel disagrees at N={n} W={w} "
                                f"threshold {t}")
            check(torch.equal(got, ref.maj_n(x, n)),
                  f"maj_n kernel disagrees with the unpacking oracle at N={n}")
        print(f"K3 maj_n N={n}: bit-exact at W = 1001, 65536, 2M, every "
              f"threshold")
    # Timed at the replica vote's shape: 3 replicas of a 2M-lane wire.
    k3_n, k3_w = 3, 1 << 21

    def k3_pair():
        t = torch.randint(-2**31, 2**31 - 1, (k3_n, k3_w), dtype=torch.int32,
                          device=cuda)
        return t, torch.empty(k3_w, dtype=torch.int32, device=cuda)

    k3_pairs = rotation(k3_pair, (k3_n + 1) * k3_w * 4)
    k3_lib = maj_n.library()
    k3_ms = cuda_ms(cycle_launch(
        k3_lib, maj_n.ENTRY,
        [(x.data_ptr(), o.data_ptr(), k3_n, k3_w, 2, _build.stream_of(x))
         for x, o in k3_pairs]), 200)
    for x, o in k3_pairs:
        check(torch.equal(o, ref.maj_n_fast(x, 2)),
              "maj_n kernel disagrees in the timing run")
    x = k3_pairs[0][0]
    k3_plain = cuda_ms(lambda: ref.maj_n_fast(x, 2), 20)
    k3_bytes = (k3_n + 1) * k3_w * 4
    k3_bound_b = k3_bytes / HBM_BYTES_PER_S * 1e3
    k3_k = k3_n.bit_length()
    k3_bound_o = k3_w * k3_n * (3 * k3_k + 1) / ALU_OPS_PER_S * 1e3
    k3_bound = max(k3_bound_b, k3_bound_o)
    print(f"K3 at N={k3_n} W={k3_w} (a 3-replica vote of 2M lanes): kernel "
          f"{k3_ms:.4f} ms, plain {k3_plain:.4f} ms, bound {k3_bound:.4f} "
          f"ms ({k3_bytes} bytes)")
    del k5_sets, k3_pairs, x, v, c

    # -- 4. the main path through the public entry point ----------------- #
    for k in list(_build.LAUNCHES):
        _build.LAUNCHES[k] = 0
    main_t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    n2m = 1 << 21
    cases = [
        ("prog16 2M lanes", 32, prog16,
         [rng.integers(0, 2**32, n2m, dtype=np.uint64) for _ in range(3)],
         {}),
        # 16 banks x 32 planes x 65536 bitlines: one full plane set of the
        # default EngineConfig (128 MiB per leaf), run as one program.
        ("prog16 32M lanes", 32, prog16,
         [rng.integers(0, 2**32, 16 * n2m, dtype=np.uint64)
          for _ in range(3)], {"flush_memory_bytes": None}),
        ("mulprog16 width 16 2M lanes", 16, mulprog16,
         [rng.integers(0, 1 << 16, n2m, dtype=np.uint64) for _ in range(3)],
         {}),
        ("wide64 width 64 2M lanes", 64, wide64,
         [rng.integers(0, 2**64 - 1, n2m, dtype=np.uint64, endpoint=True)
          for _ in range(3)], {}),
        ("bmi 30 x 2 MiB bitmaps", 32, bmi,
         [[dense_words(rng, 1 << 18) for _ in range(30)]], {}),
    ]
    for label, width, fn, args, kw in cases:
        before = dict(_build.LAUNCHES)
        dev = pum.device(width=width, **kw)
        check(dev.torch_device.type == "cuda", "default device is not cuda")
        backend = select_backend(require="fused", device=dev.torch_device,
                                 width=width, layout=dev.layout).name
        check(backend.startswith("vertical-cuda"),
              f"{label}: selected {backend}, not vertical-cuda")
        t = time.perf_counter()
        got = fn(dev, *args).to_numpy()
        cold = time.perf_counter() - t
        with pum.profile(dev) as tr:
            t = time.perf_counter()
            again = fn(dev, *args).to_numpy()
            warm = time.perf_counter() - t
        spans = {}
        for name, t0_ns, t1_ns, _ in tr.events:
            spans[name] = spans.get(name, 0.0) + (t1_ns - t0_ns) / 1e6
        host = pum.device(width=width, fuse=False, **kw)
        want = fn(host, *args).to_numpy()
        fn(host, *args)  # the same two charges as the fused device
        check(np.array_equal(got, want) and np.array_equal(again, want),
              f"{label}: fused result differs from the eager host path")
        check(dev.stats == host.stats,
              f"{label}: EngineStats differ from the eager host path")
        rose = {k: _build.LAUNCHES[k] - before.get(k, 0)
                for k in ("bit_transpose32", "run_program_cuda")}
        check(all(v > 0 for v in rose.values()),
              f"{label}: kernel launches did not rise ({rose})")
        print(f"main path {label}: backend {backend}, bit-exact vs eager "
              f"host, stats equal, cold flush {cold:.4f} s, warm flush "
              f"{warm:.4f} s, launches {rose}")
        print("  warm flush spans (ms): " + ", ".join(
            f"{k} {v:.3f}" for k, v in spans.items()))
    main_s = time.perf_counter() - main_t0
    launches = dict(_build.LAUNCHES)
    for k in ("bit_transpose32", "run_program_cuda"):
        check(launches.get(k, 0) > 0, f"{k} never launched on the main path")
    print(f"main path: {main_s:.1f} s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB, "
          f"launches {launches}")

    # -- 6. the paper's analog anchors on the card ----------------------- #
    t = time.perf_counter()
    db = MonteCarloDb(device="cuda")
    frac = db.mean("H", 3, 4)
    pulsar = db.mean("H", 3, 32)
    maj5 = db.mean("H", 5, 32)
    anchors_s = time.perf_counter() - t
    print(f"analog anchors (MonteCarloDb 2048 bitlines x 24 groups x 48 "
          f"patterns, {anchors_s:.2f} s): FracDRAM MAJ3@4 {frac:.4f}, "
          f"PULSAR MAJ3@32 {pulsar:.4f}, MAJ5@32 {maj5:.4f}")
    check(0.70 <= frac <= 0.88, f"FracDRAM MAJ3@4 {frac} outside [0.70, 0.88]")
    check(pulsar >= 0.93, f"PULSAR MAJ3@32 {pulsar} below 0.93")
    check(pulsar - frac > 0.10, f"PULSAR gain {pulsar - frac} not above 0.10")
    check(0.55 <= maj5 <= 0.92, f"MAJ5@32 {maj5} outside [0.55, 0.92]")

    # -- 7. the reliability path: full-size calibration ------------------ #
    cfg = pum.EngineConfig()
    for k in list(_build.LAUNCHES):
        _build.LAUNCHES[k] = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    rmap = pum.calibrate(cfg.mfr, banks=cfg.banks, n_subarrays=8,
                         n_columns=cfg.row_bits, n_patterns=12,
                         seed=cfg.seed, device="cuda")
    cal_s = time.perf_counter() - t
    cal_launches = dict(_build.LAUNCHES)
    check(cal_launches.get("charge_share", 0) == cfg.banks * 8
          * len(rmap.configs),
          f"calibration launched charge_share {cal_launches} times")
    check(rmap.flip_p.shape == (cfg.banks, 8, len(rmap.configs),
                                cfg.row_bits)
          and bool(np.isfinite(rmap.flip_p).all())
          and bool(((rmap.success >= 0) & (rmap.success <= 1)).all()),
          "calibration map malformed")
    per_cfg = {f"MAJ{m}@{n}": round(float(rmap.success[:, :, i].mean()), 6)
               for i, (m, n) in enumerate(rmap.configs)}
    print(f"calibration mfr {cfg.mfr}, {cfg.banks} banks x 8 subarrays x "
          f"{cfg.row_bits} columns x 12 patterns: {cal_s:.2f} s, "
          f"flip_p {rmap.flip_p.nbytes / 2**20:.0f} MiB, launches "
          f"{cal_launches}, success per config {per_cfg}")

    # -- 8. the reliability path: injected fused flushes ----------------- #
    rel_launches = collections.Counter()
    injected = [("prog16 2M lanes", 32, prog16,
                 [rng.integers(0, 2**32, n2m, dtype=np.uint64)
                  for _ in range(3)]),
                ("wide64 width 64 2M lanes", 64, wide64,
                 [rng.integers(0, 2**64 - 1, n2m, dtype=np.uint64,
                               endpoint=True) for _ in range(3)])]
    for label, width, fn, args in injected:
        # At nominal variation almost every column of the map is stable
        # (flip probabilities of 1e-5 and below, most of them 0 in
        # float32), so a 2M-lane flush would see no fault: scale the
        # probabilities at the config the flush injects at (the worst one
        # its ops were planned at) to a few expected flips per replica.
        # Scaling saturates the weakest lanes, and a saturated lane flips
        # in every replica; 7 votes keep two replicas that flip the same
        # bit from making a weak vote (it takes three). The first target
        # whose run on the CPU injects and corrects without falling back
        # is the one the card runs, and the card must count the same.
        plan_dev = pum.device(width=width, device="cpu",
                              reliability=pum.ReliabilityConfig(map=rmap))
        fn(plan_dev, *[a[:64] for a in args]).to_numpy()
        m_n = plan_dev.reliability._flush_config()
        base = rmap.config_index(*m_n)
        base = rmap.nearest_config(*m_n) if base is None else base
        n_ops = len(plan_dev.engine.last_program.ops)

        p_col = FaultInjector(rmap, base, width=width).lane_probs(n2m)
        p_col = p_col[p_col > 0]

        def expected_flips(scale):  # FaultInjector.lane_probs, summed
            return (1.0 - (1.0 - np.clip(p_col * scale, 0.0, 1.0))
                    ** n_ops).sum()

        check(p_col.size > 0, f"{label}: the map gives no flips to scale")
        for target in (8.0, 4.0, 2.0, 16.0, 32.0):
            lo, hi = 1e-30, 1e60
            for _ in range(60):  # bisect the scale in log space
                mid = math.sqrt(lo * hi)
                lo, hi = (mid, hi) if expected_flips(mid) < target \
                    else (lo, mid)
            rcfg = pum.ReliabilityConfig(map=rmap, inject=True, votes=7,
                                         flip_scale=hi)
            host = pum.device(width=width, device="cpu", reliability=rcfg)
            host_out = fn(host, *args).to_numpy()
            host_counters = {
                k: v for k, v in host.counters.as_dict()["counters"].items()
                if k.startswith("reliability.")}
            if host_counters.get("reliability.corrected_bits", 0) > 0 \
                    and not host_counters.get("reliability.oracle_fallbacks"):
                break
        print(f"injected flush {label}: config MAJ{m_n[0]}@{m_n[1]}, "
              f"target {target} flips per replica, flip_scale {hi:.6g}")
        clean = fn(pum.device(width=width), *args).to_numpy()
        dev = pum.device(width=width, reliability=rcfg)
        for k in list(_build.LAUNCHES):
            _build.LAUNCHES[k] = 0
        t = time.perf_counter()
        got = fn(dev, *args).to_numpy()
        cold = time.perf_counter() - t
        counters = {k: v for k, v in dev.counters.as_dict()["counters"].items()
                    if k.startswith("reliability.")}
        with pum.profile(dev) as tr:
            t = time.perf_counter()
            again = fn(dev, *args).to_numpy()
            warm = time.perf_counter() - t
        rose = dict(_build.LAUNCHES)
        rel_launches.update(rose)
        spans = {}
        for name, t0_ns, t1_ns, _ in tr.events:
            spans[name] = spans.get(name, 0.0) + (t1_ns - t0_ns) / 1e6
        attempts = [a.get("attempts") for nm, _, _, a in tr.events
                    if nm == "flush.dispatch"]
        check(np.array_equal(got, clean) and np.array_equal(again, clean)
              and np.array_equal(host_out, clean),
              f"{label}: injected flush differs from a non-injecting device")
        check(counters == host_counters,
              f"{label}: reliability counters differ between the card and "
              f"the CPU ({counters} vs {host_counters})")
        check(counters.get("reliability.injected_bits", 0) > 0
              and counters.get("reliability.corrected_bits", 0) > 0,
              f"{label}: no fault injected and corrected ({counters})")
        check(all(rose.get(k, 0) > 0 for k in
                  ("bit_transpose32", "run_program_cuda", "maj_n")),
              f"{label}: kernel launches did not all rise ({rose})")
        print(f"injected flush {label}: bit-exact vs a non-injecting "
              f"device, counters equal to the CPU run, cold {cold:.4f} s, "
              f"warm {warm:.4f} s (attempts {attempts}), launches {rose}")
        print(f"  reliability counters (first flush): {counters}")
        print("  warm flush spans (ms): " + ", ".join(
            f"{k} {v:.3f}" for k, v in spans.items()))

    # -- 9. results ------------------------------------------------------ #
    results["kernels"] = [
        {"name": "bit_transpose32", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/bit_transpose.cu",
         "replaces": "src/repro/kernels/bit_transpose.py:46",
         "launches": launches["bit_transpose32"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bound,
         "bound_by": "bytes", "library_ms": None,
         "build_s": _build.BUILDS[bit_transpose.build_item()[0]]["seconds"]},
        {"name": "run_program_cuda", "route": "cuda",
         "source": "src/repro_torch/kernels/codegen.py",
         "replaces": "src/repro/kernels/fused_program.py:655",
         "launches": launches["run_program_cuda"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_bound,
         "bound_by": "bytes" if k2_bound_b >= k2_bound_o else "operations",
         "library_ms": k2_lib, "build_s": k2_build},
        {"name": "maj_n", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/maj_n.cu",
         "replaces": "src/repro/kernels/maj_n.py:44",
         "launches": rel_launches["maj_n"], "max_abs_err": k3_err,
         "ms": k3_ms, "plain_ms": k3_plain, "bound_ms": k3_bound,
         "bound_by": "bytes" if k3_bound_b >= k3_bound_o else "operations",
         "library_ms": None,
         "build_s": _build.BUILDS[maj_n.build_item()[0]]["seconds"]},
        {"name": "charge_share", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/charge_share.cu",
         "replaces": "src/repro/kernels/charge_share.py:33",
         "launches": cal_launches["charge_share"], "max_abs_err": k5_err,
         "ms": k5_ms, "plain_ms": k5_plain, "bound_ms": k5_bound,
         "bound_by": "bytes" if k5_bound_b >= k5_bound_o else "operations",
         "library_ms": None,
         "build_s": _build.BUILDS[charge_share.build_item()[0]]["seconds"]},
    ]
    print(json.dumps(results))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
