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
4. drives the main path through the public entry point
   ``repro_torch.pum.device(width=...)`` (default device ``cuda``):
   prog16 at 2M and 32M lanes, mulprog16 at width 16, a width-64 program
   (two transpose tiles per lane) and a 30-bitmap AND + popcount (the
   fig20 BMI scale, raw packed-bitmap mode), each bit-exact against the
   port's eager host path with identical ``EngineStats``, on the
   ``vertical-cuda`` backend, with both kernels' launch counts rising;
5. prints one JSON line of per-kernel results, the card's name and power
   limit, and last ``{"ok": true, "device": {...}}``.

It exits non-zero, printing no result, when CUDA is unavailable or the
rest of the repository is missing. All data is made from fixed seeds.
"""

from __future__ import annotations

import itertools
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
ALU_OPS_PER_S = 67e12       # H100 SXM 32-bit non-tensor peak
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


def raw_launch(lib, entry: str, pairs, n: int):
    """A zero-argument call of a kernel library's C launch entry, cycling
    over ``(input, output)`` tensor pairs: the kernel's own time, without
    the wrapper's Python checks (which cost more than the kernel at these
    sizes). The pairs together exceed the card's 50 MB L2 cache, so each
    launch reads its input from device memory, as a flush does."""
    from repro_torch.kernels import _build
    fn = getattr(lib, entry)
    args = itertools.cycle([(x.data_ptr(), out.data_ptr(), n,
                             _build.stream_of(x)) for x, out in pairs])

    def launch():
        _build.check(lib, fn(*next(args)), entry)
    return launch


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
        from repro_torch.kernels import _build, bit_transpose, codegen, ref
        from repro_torch.kernels import fused_program as fp
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
    _build.build_many([bit_transpose.build_item()]
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

    # -- 5. results ------------------------------------------------------ #
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
    ]
    print(json.dumps(results))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
