"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --only lm_serve|lm_cells_sharded|lm_subquadratic
    python3 chip_smoke.py --only lm_moe_encdec|lm_vlm_mla|figures|lm_dense
    python3 chip_smoke.py --only kernel_bench

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
   threshold at W = 1001, 65536 and 2M words, at the chip model's [N,
   2048] for N = 1..32 over every threshold, and past 32 planes (N = 33
   to 4096, W = 1, 31, 2049, 65536); times the charge-sharing kernel
   (raw launches rotating buffers past the L2 cache) and the MAJ-N kernel
   at its four main-path shapes ([31, 65536], [3, 2M], [N, 2048] for N =
   3, 7, 15, 31, with ``tools/maj_n_timing.py``: device time, bound,
   share, and the floors of a same-bytes ``copy_`` and an empty kernel)
   beside their plain versions;
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
8. holds the bit-serial add kernel bit-exact against its plain version at
   widths 1, 8, 32 and 64 and W = 1001 and 65536 and times it at [32,
   65536] and [64, 65536] (raw launches rotating buffers past the L2), and
   the MAJ-N kernel bit-exact at N = 33, 35, 64 and 255;
9. the chip model at the paper's module geometry (``PAPER_MODULE``: 16
   banks x 8192 rows x 65536 bitlines, 1 GiB of bank state on the card),
   mfr H with a perfect-yield decoder: ``PulsarExecutor.maj`` at N_RG =
   4, 8, 16, 32 (MAJ3) and MAJ5 at 32, Multi-RowInit and Bulk-Write
   blocks of 16, a 32-bit ``BitSerialAlu.add`` over all 65536 lanes whose
   sum planes equal ``repro_torch.kernels.bitserial_add`` on the same
   planes and ``(a + b) mod 2**32``, and 8- and 16-bit ``mul`` and
   ``div``; ``chip.stats``, ``alu.op_counts`` and bank 0 equal the same
   sequence on a CPU chip, and the MAJ-N kernel launches once per APA;
10. cold-boot destruction of one ``PAPER_MODULE`` bank (8192 rows, 64 MiB)
    three ways (PULSAR, RowClone, FracDRAM): every row overwritten (or left
    neutral) and each report equal to the CPU run's;
11. the ``sim`` backend through ``repro_torch.pum.device(mfr="H",
    backend="sim")`` at its full 2048 lanes, widths 8, 16, 32 and 64, ops
    ``+ - & | ^ * // %``: results equal NumPy's and ``EngineStats`` and the
    chip's ``OpStats`` equal the same device on the CPU (the ops whose ALU
    runs out of its 512-row subarray — ``//`` and ``%`` at 32 bits, ``*``,
    ``//`` and ``%`` at 64 — raise on both, as in the reference);
12. the controller at the default geometry (16 banks, 65536 bitlines):
    prog16 at 2M lanes on ``pum.device(controller="auto")``, bit-exact
    against NumPy with ``EngineStats`` (``refresh_stall_ns`` included)
    equal to the same program on a CPU device with ``controller="auto"``;
    prints the first record's wall time (the controller's ``batch_cost``),
    the warm flush spans and the launches; then an injected prog16 2M
    flush on phase 7's map under the controller (``reliability.*``
    counters and ``EngineStats`` equal to the CPU's), and the 8-port
    crossbar stream of ``benchmarks/bank_parallelism.py`` (no timing
    violation; prints ``derive_port_counters``);
13. client contexts and ``flush_async``: eight threads, each in its own
    named ``client()`` (one under a side CUDA stream), record prog16 at 2M
    lanes and flush asynchronously; outputs bit-exact against NumPy and
    merged ``EngineStats`` equal to a serial run of the same named
    clients; prints the wall time of the eight asynchronous flushes beside
    the same eight flushed synchronously on one thread;
14. ``capture`` of prog16 at 2M and 32M lanes: replays equal NumPy, one
    recording, stats equal to re-recording, one fused-program launch and
    no ``flush.record``/``flush.optimize`` span per replay; prints the
    first call's and the warm replay's wall time (and uploads per replay)
    beside the warm uncaptured flush;
15. Fig 20 at ``benchmarks/fig20_realworld.py``'s sizes and configuration
    (mfr M, width 32, 16 banks, one shared ``MemoryController``; a PULSAR
    device and its FracDRAM twin per kernel; BMI 30 x 1024 words,
    BitWeaving 65,536 rows, TC 48 vertices, KCS 32 vertices with three
    3-cliques, kNN 8 x 256 x 32, IMS 64 x 64 with four colours, both XNOR
    layers): each kernel's own NumPy check, results and PULSAR and
    FracDRAM ``EngineStats`` equal to the same run on CPU devices; prints
    per kernel the wall time, K1/K2 launches and the refresh stall;
16. the ``fig20_*`` entries of ``tests/controller/golden_costs.json``
    (read from the fixture), reproduced on the card float for float;
17. ``python -m repro_torch.examples.pum_database`` at its full size (BMI
    over 8,000,000 users x 30 days, a 1,000,000-row BitWeaving column, a
    96-vertex triangle count) on the card, results and stats equal to the
    CPU; prints each workload's wall time; then ``kclique_star`` over a
    4096-vertex graph twice: the repeat call uploads 0 bytes;
18. offline autotune: prog16 at 2M lanes profiled under ``pum.profile`` on
    a CUDA device, ``autotune(apply=True)`` picks ``vertical-cuda`` or
    ``vertical-cuda-64``; tuned flushes bit-exact with ``EngineStats``
    equal to a static device, also after a forced live flip to the 64-bit
    layout; prints the plan and the tune's wall time; then the same tuned
    against static under phase 7's fault injection (the replica vote on
    the MAJ-N kernel), outputs equal to NumPy and stats equal;
19. online autotune (``window_flushes=4``) on a device that eight threads
    in named clients drive with ``flush_async`` (two rounds of prog16 at
    2M lanes): bit-exact against NumPy, merged stats equal to a serial
    run; prints windows and re-tunes;
20. the LM serve path (``lm_serve``): qwen1.5-0.5b at full width (24
    layers, d 1024, padded vocab 153,600, 622,978,048 parameters drawn
    from a ``torch.Generator`` on the card) in bfloat16 through
    ``repro_torch.serve.engine.ServeEngine`` with the launcher's defaults
    (max_batch 4, max_len 256), 8 requests x 16 prompt tokens x 16 new
    tokens, three ways (PuM stop predicate sync and ``async_stop``, host
    predicate): identical streams, the captured predicate replayed on
    every decoding tick (one K2 launch and the same K1 launches per tick,
    no ``flush.record`` span inside a tick); prints tok/s, TTFT, decode
    step and stop-predicate ms per tick, admission per request, launches
    and ``pum.stats.latency_ns``; then the same weights in float32 on the
    card against the CPU (16-token prefill, 4 decode steps, logits within
    1e-3, greedy tokens equal), the 10 smoke configs in float32 against
    the CPU (forward, prefill, 3 decode steps, within 1e-4), K1/K2 at the
    predicate's shapes against their plain versions, and the launcher
    ``python -m repro_torch.launch.serve --arch qwen1.5-0.5b``;
21. the LM train path (``lm_train``): ``repro_torch.train.trainer.
    train_loop`` at qwen1.5-0.5b full width (bfloat16 over float32
    masters, remat on) on the launcher's synthetic data (8 x 256 tokens,
    lr 3e-4, warmup 20) for 30 steps, the loss falling (prints step ms,
    tokens/s, peak memory and a ``torch.profiler`` reading of 3 steady
    steps); 5 steps with int8 compression (``err`` finite and nonzero);
    the 1-bit path on one step's full-width gradients on a fused card
    device against an eager CPU device (wire bitmaps, ``deq``, ``err`` and
    a ``pum_sign_majority3`` bit-identical, ``EngineStats`` equal; K1/K2
    launch, and are held at the path's largest shapes against their plain
    versions); a ``CheckpointManager`` round trip of that state (10 GB,
    restored bit for bit; free disk checked first); float32 card against
    CPU (one full-width step on 1 x 17 tokens, then the 10 smoke configs
    with int8 compression off and on: loss within 1e-5 relative, gradient
    leaves within 1e-3 of their max|g|); and the launcher
    ``python -m repro_torch.launch.train``: a simulated preemption exits
    42 with step 5 saved, a rerun resumes to step 12 with its step-5 loss
    within 1e-4 of an uninterrupted run's, then 3 steps at full width;
22. launch and distributed (``launch_and_shard``): prog16 at 2M lanes
    through ``pum.device(fused_backend="shard-words")`` over every visible
    card, bit-exact against NumPy, a ``vertical-cuda`` device and a CPU
    device with equal ``EngineStats`` (prints K1/K2 launches per card per
    flush and the warm flush's wall and spans beside ``vertical-cuda``'s);
    qwen1.5-0.5b's ``train_4k``, ``prefill_32k`` and ``decode_32k`` cells
    built by ``repro_torch.launch.steps.build_cell`` on one card's mesh at
    full width, the global batch cut to 2, 1 and 8 (the sequence lengths
    kept; ``prefill_32k`` at 8 of the 24 layers): the tensors given equal
    the analytic dry run's argument bytes, outputs finite (prints warm
    wall, peak memory, the dry run's counted FLOPs and the one-card
    bound of :func:`one_card_bound`); then the analytic dry run
    of the three cells on the 16x16 production mesh (host only), with
    each cell's collective census (a DTensor trace on ``meta`` over a
    ``fake`` process group) and the roofline's collective term;
23. the same three cells across ranks (``lm_cells_sharded``): one process
    per visible card (``repro_torch.distributed.spawn``, ``nccl``), the
    mesh ``make_test_mesh(n)`` ((1, 1) on one card, (2, 2) on four), each
    global batch phase 22's cut times the data axis, executed by
    ``Cell.run`` as DTensors under the cells' shardings: every rank's
    local argument bytes equal the dry run's on that mesh (prints each
    rank's cold and warm wall, peak memory and ``CommDebugMode``
    collective census; across cards, one warm ``train_4k`` step under
    ``torch.profiler`` by kind of kernel); the decode caches hold seeded
    random keys and values; the gathered outputs held on card 0 against
    the unsharded cell on the same weights and inputs (loss rtol 1e-3,
    parameters 5e-3 / 1e-4, logits and caches 2e-3 / 2e-5 reported and
    held at 2**-5 of their largest value, the gradients through the
    first step's AdamW moments and norm at 2**-3; on one card all but the
    moments bit-identical); the 1-bit sign path on the gathered
    ``train_4k`` gradients through K1/K2 bit-identical to an eager CPU
    device; across cards, two planted faults (a gradient's and a
    forward's sum over ranks skipped) must fail those checks;
24. the sub-quadratic family (``lm_subquadratic``), mamba2-130m and
    hymba-1.5b at full width: ``ServeEngine`` three ways (equal streams,
    K1/K2 each tick, tok/s, TTFT, the profile), float32 card against CPU,
    a 2 x 2048-token prefill whose every SSM state is held against the
    per-token recurrence (1e-4 of its largest magnitude), the
    ``train_4k``, ``prefill_32k``, ``decode_32k`` and ``long_500k`` cells
    on one card (batches cut to ``SUBQ_CUTS``), the launcher, and the
    ``serve_llm`` example;
25. the MoE and encoder-decoder families (``lm_moe_encdec``):
    moonshot-v1-16b-a3b at full width and depth, its 28.3 B weights
    drawn in bfloat16, through ``ServeEngine`` three ways (equal
    streams, K1/K2 each tick); float32 at 4 layers card against CPU with
    every MoE layer's expert ids and drop masks identical; its cells cut
    to ``MOE_ENCDEC_CUTS``; seamless-m4t-large-v2 at full width and
    depth served through ``prefill``/``decode_step`` with its encoder's
    memory (4 x 4096 frames, equal streams over two runs), float32 card
    against CPU, and its three cells;
26. the VLM and MLA families (``lm_vlm_mla``): llava-next-mistral-7b
    and deepseek-v2-236b (cut in depth, ``VLM_MLA_CUTS``) served three
    ways, float32 card against CPU, and their cells;
27. the paper's figures and tables (``figures``): every figure module of
    ``benchmarks/torch_run.py`` (Figs 3-5, 11, 14-20, Table 1, the
    bank-parallelism and reliability sweeps) on the card at the
    reference's sizes, each row held against
    ``benchmarks/torch_figures_reference.json`` (exact numbers and words
    byte-equal, Monte-Carlo numbers within their stored tolerance);
    K1, K2, K3 and K5 each launch; prints each module's seconds and
    launches;
28. the last three dense architectures (``lm_dense``): qwen3-1.7b
    (qk-norm), phi3-medium-14b and qwen2.5-32b (QKV bias; GQA groups of
    2, 4 and 5 at head_dim 128) at full width and depth, their weights
    drawn in bfloat16 (the count equal to ``count_params``), through
    ``ServeEngine`` three ways (equal streams, K1/K2 each tick); float32
    card against CPU (``DENSE_F32_LAYERS``); their cells cut to
    ``DENSE_CUTS``; the launcher for qwen3-1.7b and phi3-medium-14b;
29. the kernel and engine microbenchmarks (``kernel_bench``): the 21 rows
    of ``benchmarks/torch_kernel_bench.py`` at the reference's sizes (2M
    lanes; K3 at [31, 65536], K4, K1 and K5 at [32, 65536] timed in
    device time), each kernel row's kernel held against its plain version
    first; the rows' names and order the reference's, their set passing
    ``tools/bench_compare.py``'s row gate against ``BENCH_kernel.json``,
    every ``bit_exact``/``stats_match`` True, K1-K5 each launching;
30. prints one JSON line of per-kernel results, the card's name and power
    limit, and last ``{"ok": true, "device": {...}}``.

It exits non-zero, printing no result, when CUDA is unavailable or the
rest of the repository is missing. All data is made from fixed seeds.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import importlib
import itertools
import operator
import json
import math
import pathlib
import statistics
import subprocess
import sys
import threading
import time

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
ALU_OPS_PER_S = 67e12       # H100 SXM 32-bit non-tensor peak
FP32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
SEED = 20231202


class PhaseClock:
    """Prints the host wall time of each phase, and the total so far."""

    def __init__(self):
        self.start = self.last = time.perf_counter()

    def stamp(self, phase: str) -> None:
        now = time.perf_counter()
        print(f"[time] phase {phase}: {now - self.last:.1f} s (total "
              f"{now - self.start:.1f} s)", flush=True)
        self.last = now


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


def np_popcount(x) -> "np.ndarray":
    """Set bits per uint64 element, counted by NumPy on the host."""
    import numpy as np
    bits = np.unpackbits(np.ascontiguousarray(x).view(np.uint8))
    return bits.reshape(-1, 64).sum(axis=1, dtype=np.uint64)


def prog16_numpy(a, b, c, width: int = 32):
    """:func:`prog16` in NumPy on the host (arithmetic modulo 2**width):
    the independent check of the controller, async and capture phases."""
    import numpy as np
    m = np.uint64((1 << width) - 1)
    t = a & b
    t = t ^ c
    t = t | b
    t = (t + a) & m
    t = (t - c) & m
    t = t ^ b
    t = t & a
    t = (t + c) & m
    t = t | a
    t = (t - b) & m
    t = t ^ a
    t = t & c
    t = (t + b) & m
    t = np_popcount(t)
    t = (t + a) & m
    return t ^ c


def span_ms(tracer) -> dict:
    """Milliseconds per span name over a tracer's events."""
    spans = {}
    for name, t0_ns, t1_ns, _ in tracer.events:
        spans[name] = spans.get(name, 0.0) + (t1_ns - t0_ns) / 1e6
    return spans


def reset_launches(build) -> None:
    for k in list(build.LAUNCHES):
        build.LAUNCHES[k] = 0


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


def host_majority(rows) -> "np.ndarray":
    """MAJ over uint32 rows by counting each bit on the host (NumPy): the
    independent check of a charge-sharing result."""
    import numpy as np
    stack = np.stack(rows)
    bits = np.unpackbits(stack.view(np.uint8), axis=1, bitorder="little")
    maj = (bits.sum(axis=0) >= len(rows) // 2 + 1).astype(np.uint8)
    return np.packbits(maj, bitorder="little").view(np.uint32)


def chip_model_run(device, seed: int):
    """The chip-model phase on a ``PAPER_MODULE`` chip on ``device`` (mfr
    H, perfect-yield decoder): MAJ at N_RG 4/8/16/32 and MAJ5 at 32 on
    subarray 1, Multi-RowInit and Bulk-Write blocks of 16, then on
    subarray 0 a 32-bit ALU add over all 65536 lanes (its planes held
    against ``repro_torch.kernels.bitserial_add``) and 8- and 16-bit mul
    and div. Every result is checked against the host. Returns the chip,
    the ALU, the executor's reports and the wall seconds."""
    import numpy as np
    import torch
    from repro_torch.core.alu import BitSerialAlu
    from repro_torch.core.chip import PulsarChip
    from repro_torch.core.decoder import RowDecoder
    from repro_torch.core.geometry import PAPER_MODULE
    from repro_torch.core.profiles import MFR_H
    from repro_torch.core.pulsar import PulsarExecutor
    from repro_torch.kernels import bitserial_add

    def host(t):
        return t.cpu().numpy().view(np.uint32)

    t0 = time.perf_counter()
    g = PAPER_MODULE
    chip = PulsarChip(g, MFR_H, seed=0, trace=True, device=device)
    chip.decoder = RowDecoder(g, MFR_H, None)
    rng = np.random.default_rng(seed)
    x = PulsarExecutor(chip, bank=0, subarray=1)
    base = g.rows_per_subarray
    srcs = [base + 400 + i for i in range(5)]
    data = [rng.integers(0, 2**32, g.words_per_row, dtype=np.uint64)
            .astype(np.uint32) for _ in range(5)]
    for r, d in zip(srcs, data):
        chip.write_row(0, r, d)
    reports = []
    for i, (m, n_rg) in enumerate(((3, 4), (3, 8), (3, 16), (3, 32),
                                   (5, 32))):
        dst = base + 450 + i
        reports.append(dataclasses.asdict(x.maj(dst, srcs[:m], n_rg)))
        check(np.array_equal(host(chip.peek(0, dst)),
                             host_majority(data[:m])),
              f"{device}: MAJ{m} at N_RG {n_rg} disagrees with the host")
    for block, want in ((lambda: x.multi_row_init_block(srcs[0], 16),
                         data[0]),
                        (lambda: x.bulk_write_block(data[1], 16), data[1])):
        rows = block()
        check(len(rows) == 16 and all(
            np.array_equal(host(chip.peek(0, r)), want) for r in rows),
            f"{device}: a block of 16 did not take its row")
    alu = BitSerialAlu(PulsarExecutor(chip, 0, 0), width=32)
    lanes = g.row_bits
    a = rng.integers(0, 2**32, lanes, dtype=np.uint64)
    b = rng.integers(0, 2**32, lanes, dtype=np.uint64)
    va, vb = alu.load(a), alu.load(b)
    vs = alu.add(va, vb)
    planes = [torch.stack([chip.peek(0, r) for r in v.pos_rows])
              for v in (va, vb, vs)]
    check(torch.equal(bitserial_add(planes[0], planes[1]), planes[2]),
          f"{device}: the ALU's add planes differ from bitserial_add's")
    check(np.array_equal(alu.store(vs), (a + b) & np.uint64(2**32 - 1)),
          f"{device}: the ALU's 32-bit add differs from (a + b) mod 2**32")
    for v in (vs, va, vb):
        alu.free(v)
    for w, op in ((8, "mul"), (16, "mul"), (8, "div"), (16, "div")):
        mask = np.uint64((1 << w) - 1)
        a = rng.integers(0, 1 << w, lanes, dtype=np.uint64)
        b = rng.integers(1, 1 << w, lanes, dtype=np.uint64)  # b != 0
        va, vb = alu.load(a, w), alu.load(b, w)
        if op == "mul":
            outs = [alu.mul(va, vb)]
            want = [(a * b) & mask]
        else:
            outs = list(alu.div(va, vb))
            want = [a // b, a % b]
        for v, wv in zip(outs, want):
            check(np.array_equal(alu.store(v), wv),
                  f"{device}: the ALU's {w}-bit {op} differs from NumPy")
            alu.free(v)
        alu.free(va)
        alu.free(vb)
    if chip.device.type == "cuda":
        torch.cuda.synchronize()
    return chip, alu, reports, time.perf_counter() - t0


def destruction_run(chip, gen_fill):
    """Destroy bank 1 of ``chip`` three ways, refilling it with random data
    (``gen_fill()``) before each. Every row must end as the pattern (or
    neutral for FracDRAM). Returns {method: (report dict, seconds)}."""
    import torch
    from repro_torch.core import destruction
    from repro_torch.kernels.ref import s32
    out = {}
    for method, pattern in (("pulsar", 0x0BADF00D), ("rowclone", 0x5A5A5A5A),
                            ("fracdram", None)):
        chip.banks[1].copy_(gen_fill())
        chip.neutral[1] = False
        t = time.perf_counter()
        if method == "pulsar":
            rep = destruction.destroy_bank_pulsar(chip, 1, pattern=pattern)
        elif method == "rowclone":
            rep = destruction.destroy_bank_rowclone(chip, 1, pattern=pattern)
        else:
            rep = destruction.destroy_bank_fracdram(chip, 1)
        if chip.device.type == "cuda":
            torch.cuda.synchronize()
        sec = time.perf_counter() - t
        if pattern is None:
            check(bool(chip.neutral[1].all()),
                  f"{chip.device}: FracDRAM left a row with data")
        else:
            check(bool((chip.banks[1] == s32(pattern)).all())
                  and not chip.neutral[1].any(),
                  f"{chip.device}: {method} left a row not overwritten")
        out[method] = (dataclasses.asdict(rep), sec)
    return out


SIM_OPS = (("+", operator.add), ("-", operator.sub), ("&", operator.and_),
           ("|", operator.or_), ("^", operator.xor), ("*", operator.mul),
           ("//", operator.floordiv), ("%", operator.mod))
# The sim ALU allocates from one 512-row subarray; these run out of rows
# and raise, in the reference as in the port.
SIM_RAISES = {(32, "//"), (32, "%"), (64, "*"), (64, "//"), (64, "%")}


def sim_run(pum, device, width: int, a, b):
    """Every op of SIM_OPS on one ``backend="sim"`` device; each result an
    ndarray, or the RuntimeError's text when the op raised."""
    import numpy as np
    dev = pum.device(mfr="H", width=width, backend="sim", device=device)
    out = {}
    for name, fn in SIM_OPS:
        try:
            out[name] = np.asarray(fn(dev.asarray(a), b))
        except RuntimeError as e:
            out[name] = str(e)
    return dev, out


K12 = ("bit_transpose32", "run_program_cuda")
FIG20_XNOR = {"xnor_lenet_c3": (6, 16, 5, 5, 10, 10),
              "xnor_vgg_l5": (256, 256, 3, 3, 8, 8)}


def fig20_inputs():
    """``benchmarks/fig20_realworld.py``'s kernels and inputs, drawn from
    ``default_rng(20)`` in its order: ``(row, realworld function, args)``."""
    import numpy as np
    rng = np.random.default_rng(20)
    bitmaps = rng.integers(0, 2**63, (30, 1024), dtype=np.uint64)
    col = rng.integers(0, 100000, 65536, dtype=np.uint64)
    adj = np.triu((rng.random((48, 48)) < 0.25).astype(np.uint8), 1)
    cl_adj = np.triu((rng.random((32, 32)) < 0.4).astype(np.uint8), 1)
    q = rng.integers(0, 256, (8, 32), dtype=np.int64)
    r = rng.integers(0, 256, (256, 32), dtype=np.int64)
    img = rng.integers(0, 256, (64, 64), dtype=np.int64)
    return [("bmi", "bmi_active_users", (bitmaps,)),
            ("bitweaving", "bitweaving_scan", (col, 1000, 60000)),
            ("triangle_count", "triangle_count", (adj + adj.T,)),
            ("kclique_star", "kclique_star",
             (cl_adj + cl_adj.T, [(0, 1, 2), (3, 4, 5), (6, 7, 8)])),
            ("knn", "knn_distances", (q, r)),
            ("image_seg", "image_segmentation",
             (img, np.array([20, 90, 160, 230])))]


def fig20_run(pum, realworld, build, device: str, ctrl) -> list:
    """Fig 20 as ``benchmarks/fig20_realworld.py`` runs it: per kernel a
    fresh PULSAR device and its FracDRAM twin (mfr M, width 32, 16 banks,
    priced through the shared controller ``ctrl``), then both XNOR layers
    on one pair. Each kernel checks its own result against NumPy. Returns
    one dict per row: result, PULSAR and FracDRAM latency and stats,
    refresh stall, the PULSAR call's wall time and K1/K2 launches."""
    cfg = pum.EngineConfig(mfr="M", width=32, banks=16, controller=ctrl,
                           device=device)
    rows = []
    for name, fn_name, args in fig20_inputs():
        fn = getattr(realworld, fn_name)
        pul = pum.device(cfg)
        frac = pum.device(cfg.replace(use_pulsar=False))
        before = dict(build.LAUNCHES)
        t = time.perf_counter()
        got, p_ms, _ = fn(pul, *args)
        wall = time.perf_counter() - t
        rose = {k: build.LAUNCHES[k] - before.get(k, 0) for k in K12}
        got_f, f_ms, _ = fn(frac, *args)
        rows.append({"name": name, "result": got, "result_frac": got_f,
                     "pulsar_ms": p_ms, "frac_ms": f_ms,
                     "refresh_ms": pul.stats.refresh_stall_ns * 1e-6,
                     "wall_s": wall, "launches": rose,
                     "stats": pul.stats.as_dict(),
                     "stats_frac": frac.stats.as_dict()})
    pul = pum.device(cfg)
    frac = pum.device(cfg.replace(use_pulsar=False))
    for name, spec in FIG20_XNOR.items():
        t = time.perf_counter()
        p_ms = realworld.xnor_conv_cost(pul, *spec)
        wall = time.perf_counter() - t
        f_ms = realworld.xnor_conv_cost(frac, *spec)
        rows.append({"name": name, "result": None, "result_frac": None,
                     "pulsar_ms": p_ms, "frac_ms": f_ms,
                     "refresh_ms": pul.stats.refresh_stall_ns * 1e-6,
                     "wall_s": wall, "launches": {k: 0 for k in K12},
                     "stats": pul.stats.as_dict(),
                     "stats_frac": frac.stats.as_dict()})
    return rows


def golden_fig20(pum, realworld, device: str) -> dict:
    """``tests/controller/golden_costs.json``'s two ``fig20_*`` workloads
    (its own seeds and configs) on ``device``, in the fixture's shape."""
    import numpy as np
    rng = np.random.default_rng(0)
    bitmaps = (rng.integers(0, 1 << 63, (7, 64), dtype=np.uint64)
               | rng.integers(0, 1 << 63, (7, 64), dtype=np.uint64))
    dev = pum.device(width=64, fuse=True, device=device)
    got, _, _ = realworld.bmi_active_users(dev, bitmaps)
    out = {"fig20_bmi_active_users": {
        "result": got, "latency_ns": dev.stats.latency_ns,
        "energy_j": dev.stats.energy_j,
        "n_sequences": dev.stats.n_sequences}}
    col = rng.integers(0, 1 << 20, 4096, dtype=np.uint64)
    dev = pum.device(width=32, fuse=True, device=device)
    got, _, _ = realworld.bitweaving_scan(dev, col, 1000, 800000)
    out["fig20_bitweaving_scan"] = {
        "result": got, "latency_ns": dev.stats.latency_ns,
        "energy_j": dev.stats.energy_j,
        "n_sequences": dev.stats.n_sequences}
    return out


def programs_of(engine_mod, fn) -> list:
    """Every fused program ``fn()`` flushes (recorded on a CPU device, so
    the card's kernels can be built for them up front, in parallel)."""
    seen = []
    real = engine_mod.get_pipeline

    def spy(program, **kw):
        seen.append(program)
        return real(program, **kw)

    engine_mod.get_pipeline = spy
    try:
        fn()
    finally:
        engine_mod.get_pipeline = real
    return seen


def apps_and_autotune(pum, device: str, ops16, want16, seed: int,
                      rcfg) -> dict:
    """The app-kernel and autotune phases on ``device`` (``"cuda"`` on the
    card; ``"cpu"`` rehearses them with the kernels' plain versions), each
    with the launch counts set to 0 just before it. Every result is held
    against NumPy or a CPU device; returns the launches and timings the
    results line reports."""
    import contextlib
    import io

    import numpy as np
    from repro_torch.autotune import TunedPlan
    from repro_torch.controller import MemoryController
    from repro_torch.core import engine as engine_mod
    from repro_torch.core import realworld
    from repro_torch.examples import pum_database
    from repro_torch.kernels import _build, codegen

    on_card = device != "cpu"
    want_backend = "vertical-cuda" if on_card else "words-torch"
    out = {}

    def prebuild(programs):
        if on_card:
            t = time.perf_counter()
            items = {codegen.build_item(p) for p in programs}
            _build.build_many(sorted(items))
            print(f"  built {len(items)} fused-program kernels in "
                  f"{time.perf_counter() - t:.1f} s (parallel nvcc)")

    # -- 15. Fig 20 at benchmarks/fig20_realworld.py's sizes and config -- #
    host_ctrl = MemoryController(n_banks=16)
    t = time.perf_counter()
    host_rows = []
    prebuild(programs_of(engine_mod, lambda: host_rows.extend(fig20_run(
        pum, realworld, _build, "cpu", host_ctrl))))
    host_s = time.perf_counter() - t
    reset_launches(_build)
    t = time.perf_counter()
    rows = fig20_run(pum, realworld, _build, device, MemoryController(
        n_banks=16))
    fig20_s = time.perf_counter() - t
    out["fig20_launches"] = dict(_build.LAUNCHES)
    for row, host in zip(rows, host_rows):
        name = row["name"]
        check(np.array_equal(np.asarray(row["result"]),
                             np.asarray(host["result"]))
              and np.array_equal(np.asarray(row["result_frac"]),
                                 np.asarray(host["result"])),
              f"fig20 {name}: result differs from the CPU device")
        check(row["stats"] == host["stats"]
              and row["stats_frac"] == host["stats_frac"],
              f"fig20 {name}: PULSAR or FracDRAM EngineStats differ from "
              f"the CPU device")
        check(row["refresh_ms"] > 0, f"fig20 {name}: no refresh stall")
        if row["result"] is not None:
            check(all(row["launches"][k] > 0 for k in K12) or not on_card,
                  f"fig20 {name}: K1/K2 did not launch ({row['launches']})")
        ratio = row["frac_ms"] / row["pulsar_ms"]
        print(f"fig20 {name}: pulsar {row['pulsar_ms']:.3f} ms, frac "
              f"{row['frac_ms']:.3f} ms (x{ratio:.2f}), refresh "
              f"{row['refresh_ms']:.4f} ms; wall {row['wall_s']:.4f} s (CPU "
              f"device {host['wall_s']:.4f} s), K1/K2 launches "
              f"{row['launches']}; result and PULSAR/FracDRAM EngineStats "
              f"equal the CPU device")
    print(f"fig20: {fig20_s:.2f} s on {device} (CPU device run {host_s:.2f}"
          f" s), launches {out['fig20_launches']}")

    # -- 16. the golden fig20 entries ------------------------------------ #
    fixture = json.loads((ROOT / "tests" / "controller"
                          / "golden_costs.json").read_text())
    prebuild(programs_of(engine_mod,
                         lambda: golden_fig20(pum, realworld, "cpu")))
    reset_launches(_build)
    got = golden_fig20(pum, realworld, device)
    for key, entry in got.items():
        check(entry == fixture[key], f"golden {key}: {entry} differs from "
                                     f"the fixture {fixture[key]}")
    print(f"golden fig20 entries on {device}: equal to "
          f"tests/controller/golden_costs.json float for float {got}; "
          f"launches {dict(_build.LAUNCHES)}")

    # -- 17. pum_database at its full size ------------------------------- #
    host_db = {}
    with contextlib.redirect_stdout(io.StringIO()):
        prebuild(programs_of(engine_mod, lambda: host_db.update(
            pum_database.main(device="cpu"))))
    reset_launches(_build)
    t = time.perf_counter()
    db = pum_database.main(device=device)
    db_s = time.perf_counter() - t
    out["db_launches"] = dict(_build.LAUNCHES)
    for key in ("bmi", "bitweaving", "triangle_count"):
        check(db[key][0] == host_db[key][0],
              f"pum_database {key}: result differs from the CPU device")
    check(db["stats"] == host_db["stats"],
          "pum_database: EngineStats differ from the CPU device")
    print("pum_database (8,000,000 users x 30 days, 1,000,000 rows, 96 "
          "vertices): " + ", ".join(
              f"{k} {db[k][1]:.4f} s (CPU device {host_db[k][1]:.4f} s)"
              for k in ("bmi", "bitweaving", "triangle_count"))
          + f"; {db_s:.2f} s in all, launches {out['db_launches']}")

    rng = np.random.default_rng(seed)
    n = 4096
    adj = np.triu((rng.random((n, n)) < 0.5).astype(np.uint8), 1)
    adj = adj + adj.T
    sets = [tuple(int(v) for v in rng.choice(n, 3, replace=False))
            for _ in range(1024)]
    kdev = pum.device(mfr="M", width=32, banks=16, device=device)
    uploads = []
    real_upload = engine_mod._upload

    def counting_upload(wire, dev):
        uploads.append(wire.nbytes)
        return real_upload(wire, dev)

    prebuild(programs_of(engine_mod, lambda: realworld.kclique_star(
        pum.device(mfr="M", device="cpu"), adj[:64, :64], [(0, 1, 2)])))
    kcs = []
    engine_mod._upload = counting_upload
    try:
        for _ in range(2):
            uploads.clear()
            t = time.perf_counter()
            got = realworld.kclique_star(kdev, adj, sets)[0]
            kcs.append((got, time.perf_counter() - t, sum(uploads),
                        len(uploads)))
    finally:
        engine_mod._upload = real_upload
    check(kcs[0][0] == kcs[1][0], "kclique_star: repeat call differs")
    check(kcs[0][2] > 0 and kcs[1][2] == 0,
          f"kclique_star: the repeat call uploaded {kcs[1][2]} bytes")
    out["kcs_upload_bytes"] = [k[2] for k in kcs]
    print(f"kclique_star {n} vertices x {len(sets)} vertex triples: "
          f"{kcs[0][0]} common neighbours; first call {kcs[0][1]:.4f} s "
          f"({kcs[0][3]} uploads, {kcs[0][2]} bytes), repeat call "
          f"{kcs[1][1]:.4f} s ({kcs[1][3]} uploads, {kcs[1][2]} bytes)")

    # -- 18. autotune, offline ------------------------------------------- #
    prebuild(programs_of(engine_mod, lambda: [
        prog16(pum.device(width=32, layout=lay, device="cpu"),
               *[a[:64] for a in ops16]).to_numpy() for lay in (32, 64)]))
    reset_launches(_build)
    tdev = pum.device(width=32, device=device)
    sdev = pum.device(width=32, device=device)
    with pum.profile(tdev):
        primed = prog16(tdev, *ops16).to_numpy()
    t = time.perf_counter()
    plan = tdev.autotune(apply=True)
    tune_s = time.perf_counter() - t
    check(plan.fused_backend in (want_backend, want_backend + "-64"),
          f"autotune picked {plan.fused_backend}")
    tuned = prog16(tdev, *ops16).to_numpy()
    static = [prog16(sdev, *ops16).to_numpy() for _ in range(2)]
    check(all(np.array_equal(x, want16) for x in [primed, tuned] + static),
          "autotune: prog16 differs from NumPy")
    check(tdev.stats == sdev.stats,
          "autotune: tuned EngineStats differ from the static device")
    flipped = dataclasses.replace(plan, fused_backend=want_backend + "-64",
                                  word_bits=64)
    t = time.perf_counter()
    tdev._apply_plan(flipped)
    flip_s = time.perf_counter() - t
    check(tdev.layout.word_bits == 64, "autotune: the layout did not flip")
    after = prog16(tdev, *ops16).to_numpy()
    prog16(sdev, *ops16).to_numpy()
    check(np.array_equal(after, want16),
          "autotune: prog16 after the live 32 -> 64 flip differs")
    check(tdev.stats == sdev.stats,
          "autotune: EngineStats differ after the live layout flip")
    check(tdev.engine.last_program.layout.word_bits == 64,
          "autotune: the flush after the flip ran the 32-bit program")
    out["autotune_launches"] = dict(_build.LAUNCHES)
    out["tune_s"] = tune_s
    # Tuned against static under fault injection (``rcfg``): the replica
    # vote runs on both sides and the outputs still equal NumPy.
    reset_launches(_build)
    idev = pum.device(width=32, device=device, reliability=rcfg)
    istatic = pum.device(width=32, device=device, reliability=rcfg)
    with pum.profile(idev):
        inj = [prog16(idev, *ops16).to_numpy()]
    iplan = idev.autotune(apply=True)
    inj.append(prog16(idev, *ops16).to_numpy())
    inj += [prog16(istatic, *ops16).to_numpy() for _ in range(2)]
    check(all(np.array_equal(x, want16) for x in inj),
          "autotune under injection: prog16 differs from NumPy")
    check(idev.stats == istatic.stats,
          "autotune under injection: EngineStats differ from static")
    check(idev.counters.get("reliability.votes_run", 0) > 0,
          "autotune under injection: no replica vote")
    out["injected_launches"] = dict(_build.LAUNCHES)
    check(out["injected_launches"].get("maj_n", 0) > 0 or not on_card,
          "autotune under injection: maj_n never launched")
    print(f"autotune offline, prog16 2M lanes profiled on {device}: plan "
          f"{plan!r}, knobs {plan.knobs()}, tune {tune_s * 1e3:.2f} ms, "
          f"apply of the 64-bit flip {flip_s * 1e3:.2f} ms; tuned and "
          f"flipped flushes bit-exact, EngineStats equal the static "
          f"device; launches {out['autotune_launches']} (4 flushes)")
    print(f"autotune under injection (prog16 2M, phase 7's map, 7 votes): "
          f"plan {iplan!r}; tuned and static flushes equal NumPy, "
          f"EngineStats equal; launches {out['injected_launches']} "
          f"(4 injected flushes)")

    # -- 19. autotune, online, under eight async clients ------------------ #
    n_clients = 8
    client_ops = [[rng.integers(0, 2**32, ops16[0].size, dtype=np.uint64)
                   for _ in range(3)] for _ in range(n_clients)]
    client_want = [prog16_numpy(*o) for o in client_ops]
    odev = pum.device(width=32, device=device)
    serial = pum.device(width=32, device=device)
    reset_launches(_build)
    outs = {}
    errors = []

    def client(i, rnd):
        try:
            with odev.client(f"c{i}"):
                h = prog16(odev, *client_ops[i])
                odev.flush_async().result(timeout=300)
            outs[(i, rnd)] = h.to_numpy()
        except Exception as e:  # re-raised on the main thread
            errors.append(e)

    t = time.perf_counter()
    with pum.profile(odev):
        check(odev.autotune(online=True, window_flushes=4) is None,
              "online autotune returned a plan before any window")
        for rnd in range(2):
            threads = [threading.Thread(target=client, args=(i, rnd))
                       for i in range(n_clients)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=600)
            check(not any(th.is_alive() for th in threads),
                  "online autotune: async clients hung")
            if errors:
                raise errors[0]
    online_s = time.perf_counter() - t
    for rnd in range(2):
        for i in range(n_clients):
            with serial.client(f"c{i}"):
                prog16(serial, *client_ops[i]).to_numpy()
    ot = odev.engine.autotuner
    check(all(np.array_equal(outs[(i, r)], client_want[i])
              for i in range(n_clients) for r in range(2)),
          "online autotune: a client's output differs from NumPy")
    check(odev.stats == serial.stats,
          "online autotune: merged EngineStats differ from a serial run")
    # 16 flushes close 4 windows; a window whose ops were all recorded
    # before the previous one closed carries none and is skipped, so how
    # many count depends on how far the clients ran ahead of the worker.
    check(ot._flushes == 0 and 1 <= ot.windows <= 4 and ot.retunes >= 1
          and not ot._busy,
          f"online autotune: {ot.windows} windows, {ot.retunes} retunes")
    out["online_launches"] = dict(_build.LAUNCHES)
    odev.close()
    print(f"autotune online (window_flushes=4), {n_clients} named clients x "
          f"2 rounds of prog16 2M lanes with flush_async: bit-exact vs "
          f"NumPy, merged EngineStats equal a serial run; windows "
          f"{ot.windows}, retunes {ot.retunes}, plan {ot.plan!r}, device "
          f"now {odev.config.fused_backend or want_backend} u"
          f"{odev.layout.word_bits}; {online_s:.3f} s, launches "
          f"{out['online_launches']}")
    return out


SERVE_ARCH = "qwen1.5-0.5b"      # launch/serve.py's documented example
SERVE_F32_TOL = 1e-3   # full width, card vs CPU, float32 logits (~0.6)
SMOKE_F32_TOL = 1e-4   # the 10 smoke configs, card vs CPU, float32


def serve_run(eng, Request, prompts, build, max_new: int) -> dict:
    """Drive ``eng`` over ``prompts`` as ``run_until_drained`` does, one
    ``tick()`` at a time, with the kernel counts set to 0 first; returns
    the streams, the wall, the per-tick K1/K2 launches and the spans."""
    import numpy as np
    import torch
    reset_launches(build)
    t0 = time.perf_counter()
    for rid, p in enumerate(prompts):
        eng.submit(Request(rid=rid, prompt=p, max_new_tokens=max_new))
    ticks = []
    while eng.queue or any(r is not None for r in eng.slot_req):
        before = dict(build.LAUNCHES)
        eng.tick()
        ticks.append({k: build.LAUNCHES.get(k, 0) - before.get(k, 0)
                      for k in K12})
    done = eng.run_until_drained()      # joins the last async predicate
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    wall = time.perf_counter() - t0
    events = eng.tracer.events
    tick_spans = [(a, b) for n, a, b, _ in events if n == "serve.tick"]

    def ms(name):
        return [(b - a) / 1e6 for n, a, b, _ in events if n == name]

    records = sum(1 for n, a, b, _ in events if n == "flush.record"
                  and any(t0 <= a and b <= t1 for t0, t1 in tick_spans))
    ttft = [r.t_first - r.t_submit for r in done]
    n_tok = sum(len(r.out_tokens) for r in done)
    return {
        "streams": sorted((r.rid, tuple(r.out_tokens)) for r in done),
        "wall_s": wall, "tokens": n_tok, "tok_s": n_tok / wall,
        "ttft_mean_ms": float(np.mean(ttft)) * 1e3,
        "ttft_max_ms": float(np.max(ttft)) * 1e3,
        "ticks": ticks, "decode_ms": ms("serve.decode"),
        "stop_ms": ms("serve.stop_predicate"), "admit_ms": ms("serve.admit"),
        "records_in_ticks": records,
        "launches": {k: build.LAUNCHES.get(k, 0) for k in K12},
        "pum_latency_ns": (eng.pum.stats.latency_ns
                           if eng.pum is not None else None),
        "replays": (eng._stop_prog.n_replays if eng.pum is not None
                    else 0),
    }


def profile_ticks(step, n_ticks: int, wall_ms: float | None = None
                  ) -> dict | None:
    """``n_ticks`` steady calls of ``step`` (a serve tick, a train step)
    timed on the host clock (or ``wall_ms``, a warm call's wall the
    caller measured), then ``n_ticks`` more under ``torch.profiler`` (the
    CUDA activity alone: the device events are the same with the CPU's,
    and their summary takes half the host time): the device time summed
    over the device-side events (kernels, copies, memsets; one stream, so
    they do not overlap)
    and their count, per call; the idle share is 1 - device time / the
    unprofiled call's wall. Also the profiled wall and
    the five most frequent device events and the five longest (name,
    count and ms per call), and the device time per call by kind of
    kernel (``nccl`` collectives; float32 GEMMs, which run outside the
    tensor cores; other GEMMs; the rest). ``None`` when the profiler saw
    no device events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    if wall_ms is None:
        t0 = time.perf_counter()
        for _ in range(n_ticks):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_ticks
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_ticks):
            step()
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3 / n_ticks
    # Device kernels only: a collective's annotation (``nccl:...``) spans
    # its kernel on the device timeline and would count it twice.
    dev = [(evt.key, evt.count, evt.self_device_time_total)
           for evt in prof.key_averages()
           if evt.device_type == DeviceType.CUDA
           and not getattr(evt, "is_user_annotation", False)]
    dev_us = sum(us for _, _, us in dev)
    if dev_us == 0:
        return None
    device_ms = dev_us / 1e3 / n_ticks
    def per_call(events):
        return [(k[:48], n / n_ticks, us / 1e3 / n_ticks)
                for k, n, us in events]

    def kind(name: str) -> str:
        low = name.lower()
        if "nccl" in low:
            return "nccl"
        if any(m in low for m in ("gemm", "nvjet", "xmma", "cutlass")):
            return ("gemm float32" if any(m in low for m in (
                "sgemm", "f32f32_f32f32", "_sss", "simt")) else "gemm other")
        return "other"

    kinds = collections.Counter()
    for name, _, us in dev:
        kinds[kind(name)] += us / 1e3 / n_ticks
    return {"wall_ms": wall_ms, "profiled_wall_ms": profiled_ms,
            "device_ms": device_ms,
            "idle_share": 1 - device_ms / wall_ms,
            "device_ops": sum(n for _, n, _ in dev) / n_ticks,
            "top_ops": per_call(sorted(dev, key=lambda e: -e[1])[:5]),
            "top_time": per_call(sorted(dev, key=lambda e: -e[2])[:5]),
            "kinds": dict(kinds)}


def lm_inputs(cfg, rng, b: int, t: int, device,
              prefix: int | None = None) -> dict:
    """A seeded batch for ``cfg`` on ``device``: ``t`` tokens, and for the
    stub frontends ``prefix`` audio frames (``t`` unless given) or
    patches (``n_frontend_tokens`` unless given), normal with scale
    0.02."""
    import numpy as np
    import torch
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int64))}
    if cfg.encoder_decoder:
        batch["frames"] = torch.as_tensor(rng.standard_normal(
            (b, prefix or t, cfg.d_model), np.float32) * 0.02)
    if cfg.frontend == "vision":
        batch["patches"] = torch.as_tensor(rng.standard_normal(
            (b, prefix or cfg.n_frontend_tokens, cfg.d_model),
            np.float32) * 0.02)
    return {k: v.to(device) for k, v in batch.items()}


def lm_parity(cfg, dev_params, cpu_params, batch, device, steps: int,
              forward: bool, keep: list | None = None) -> tuple[dict, bool]:
    """Forward, prefill and ``steps`` greedy decode steps of ``cfg`` with
    the same parameters on ``device`` and on the CPU (positions after the
    batch's patch prefix, if any); returns the max abs logit error per
    stage and whether the greedy tokens agreed. ``keep``, when given,
    takes the device's prefill and decode logits, on the host."""
    import torch
    from repro_torch.models import model as lm

    def host(tree):
        return {k: v.cpu() for k, v in tree.items()}

    b = batch["tokens"].shape[0]
    extra = batch["patches"].shape[1] if "patches" in batch else 0
    t = batch["tokens"].shape[1] + extra
    keep = [] if keep is None else keep
    errs = {}
    with torch.no_grad():
        if forward:
            got, _ = lm.forward(cfg, dev_params, batch)
            want, _ = lm.forward(cfg, cpu_params, host(batch))
            errs["forward"] = float((got.cpu() - want).abs().max())
        got, gc, gm = lm.prefill(cfg, dev_params, batch, t + steps)
        want, wc, wm = lm.prefill(cfg, cpu_params, host(batch), t + steps)
        errs["prefill"] = float((got.cpu() - want).abs().max())
        keep.append(got.cpu())
        same = True
        for i in range(steps):
            gt = got[:, :cfg.vocab_size].argmax(-1)
            wt = want[:, :cfg.vocab_size].argmax(-1)
            same = same and torch.equal(gt.cpu(), wt)
            pos = torch.full((b,), t + i, dtype=torch.long)
            got, gc = lm.decode_step(cfg, dev_params, gc, gt, pos.to(device),
                                     memory=gm)
            want, wc = lm.decode_step(cfg, cpu_params, wc, wt, pos,
                                      memory=wm)
            errs[f"decode{i}"] = float((got.cpu() - want).abs().max())
            keep.append(got.cpu())
    return errs, same


def serve_three_ways(cfg, params, build, dev, tag: str) -> dict:
    """``cfg`` with ``params`` on ``dev`` through ``ServeEngine`` (max_batch
    4, max_len 256, eos -1: the launcher's defaults): 8 requests of
    16-token prompts from ``default_rng(0)``, 16 new tokens each, three
    ways (PuM stop predicate sync, ``async_stop``, host predicate); the
    streams are identical, every decoding tick of the PuM runs replays
    the captured predicate (one K2 launch, the same K1 launches each
    tick, no ``flush.record`` span inside a tick). On the card, 8 steady
    ticks are profiled. Lines are printed under ``tag``; returns the runs
    (``serve``), the profile and the sync run's launches."""
    import numpy as np
    from repro_torch.serve.engine import Request, ServeEngine
    on_card = dev.type == "cuda"
    prng = np.random.default_rng(0)
    prompts = [prng.integers(0, cfg.vocab_size, 16, dtype=np.int32)
               for _ in range(8)]
    kw = dict(max_batch=4, max_len=256, eos_id=-1, device=dev,
              telemetry=True)
    warm = ServeEngine(cfg, params=params, **kw)
    serve_run(warm, Request, prompts[:1], build, max_new=2)
    warm.close()
    runs = {}
    for label, mode in (("sync", {}), ("async_stop", {"async_stop": True}),
                        ("host", {"pum_bulk": False})):
        eng = ServeEngine(cfg, params=params, **kw, **mode)
        runs[label] = r = serve_run(eng, Request, prompts, build,
                                    max_new=16)
        eng.close()
        check(r["tokens"] == 128 and all(len(s) == 16
                                         for _, s in r["streams"]),
              f"{tag} {label}: {r['tokens']} tokens")
        n_dec = len(r["decode_ms"])
        if label != "host":
            check(r["records_in_ticks"] == 0,
                  f"{tag} {label}: {r['records_in_ticks']} flush.record "
                  f"spans inside ticks (the predicate re-recorded)")
            check(r["replays"] == n_dec,
                  f"{tag} {label}: {r['replays']} replays for {n_dec} "
                  f"decoding ticks")
        if on_card and label == "sync":
            decoding = [k for k in r["ticks"] if k["run_program_cuda"]]
            check(len(decoding) == n_dec and all(
                k["run_program_cuda"] == 1
                and k["bit_transpose32"] == decoding[0]["bit_transpose32"]
                > 0 for k in decoding),
                  f"serve sync: K1/K2 launches per tick {r['ticks']}")
        if on_card and label != "host":
            check(r["launches"]["run_program_cuda"] == n_dec
                  and r["launches"]["bit_transpose32"] > 0,
                  f"{tag} {label}: launches {r['launches']} over {n_dec} "
                  f"decoding ticks")
        if label == "host":
            check(all(v == 0 for v in r["launches"].values()),
                  f"{tag} host: kernels launched {r['launches']}")
        per_tick = {k: v / max(n_dec, 1) for k, v in r["launches"].items()}
        print(f"{tag} {label}: {r['tokens']} tokens in {r['wall_s']:.3f} s "
              f"= {r['tok_s']:.1f} tok/s, TTFT mean "
              f"{r['ttft_mean_ms']:.1f} ms max {r['ttft_max_ms']:.1f} ms; "
              f"{n_dec} decoding ticks, decode step "
              f"{statistics.mean(r['decode_ms']):.3f} ms/tick (median "
              f"{statistics.median(r['decode_ms']):.3f}), stop predicate "
              f"{statistics.mean(r['stop_ms']):.3f} ms/tick (median "
              f"{statistics.median(r['stop_ms']):.3f}), admission "
              f"{sum(r['admit_ms']) / 8:.3f} ms/request; K1/K2 launches "
              f"{r['launches']} ({per_tick['bit_transpose32']:.2f}/"
              f"{per_tick['run_program_cuda']:.2f} per decoding tick), "
              f"flush.record spans in ticks {r['records_in_ticks']}, "
              f"replays {r['replays']}, pum.stats.latency_ns "
              f"{r['pum_latency_ns']}")
    check(runs["sync"]["streams"] == runs["async_stop"]["streams"]
          == runs["host"]["streams"],
          f"{tag}: the three modes gave different token streams")
    print(f"{tag}: token streams identical across sync, async_stop and "
          "the host predicate")
    out = {}
    out["serve"] = {k: {kk: vv for kk, vv in v.items()
                        if kk not in ("streams", "ticks")}
                    for k, v in runs.items()}
    if on_card:
        # Device busy and idle share over 8 + 8 steady ticks (4 slots
        # busy, no admission): the decode step and the predicate's replay.
        eng = ServeEngine(cfg, params=params, **kw)
        for rid, p in enumerate(prompts[:4]):
            eng.submit(Request(rid=rid, prompt=p, max_new_tokens=24))
        eng.tick()
        prof = profile_ticks(eng.tick, 8)
        eng.run_until_drained()
        eng.close()
        out["serve_profile"] = prof
        print(f"{tag} sync, 8 steady ticks under torch.profiler: " + (
            "device time not measured (the profiler saw no device events)"
            if prof is None else
            f"{prof['wall_ms']:.3f} ms/tick wall unprofiled "
            f"({prof['profiled_wall_ms']:.3f} profiled), device busy "
            f"{prof['device_ms']:.3f} ms/tick, idle share "
            f"{prof['idle_share']:.3f}, {prof['device_ops']:.1f} device "
            f"kernels and copies per tick; most frequent (name, per tick, "
            f"ms per tick): " + "; ".join(
                f"{k} {n:.1f} {ms:.3f}" for k, n, ms in prof["top_ops"])))
    out["serve_launches"] = runs["sync"]["launches"]
    return out


def serve_launcher(arch: str, device: str) -> None:
    """``python -m repro_torch.launch.serve --arch ARCH --device DEVICE``
    in process, as a user runs it (``--smoke`` on the CPU): it serves 8
    requests of 16 new tokens; prints its line."""
    import contextlib
    import io
    from repro_torch.launch import serve as launch_serve
    argv = ["--arch", arch, "--device", device]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        check(launch_serve.main(argv + (["--smoke"] if device == "cpu"
                                        else [])) == 0,
              f"{arch}: the launcher failed")
    line = buf.getvalue().strip()
    check(line.startswith(f"[serve] {arch}: 8 requests, 128 tokens"),
          f"launcher printed {line!r}")
    print(f"launcher (python -m repro_torch.launch.serve {' '.join(argv)}): "
          f"{line}")


def lm_serve(device: str, build, stop_program, seed: int) -> dict:
    """The LM serve phases on ``device`` (``"cuda"`` on the card; on the
    CPU they rehearse at the arch's smoke config):

    a. qwen1.5-0.5b at full width in bfloat16 (``init_params`` from a
       ``torch.Generator`` seeded 0 on the device) through ``ServeEngine``
       three ways (:func:`serve_three_ways`);
    b. the same parameters in float32 on the device and on the CPU: a
       16-token prefill and 4 decode steps, logits within
       ``SERVE_F32_TOL`` and the greedy tokens equal;
    c. all 10 smoke configs (``torch.Generator`` seed 0 on the CPU,
       copied to the device): forward, prefill and 3 decode steps in
       float32 within ``SMOKE_F32_TOL`` of the CPU;
    d. K1 and K2 at the stop predicate's shapes against their plain
       versions, timed;
    e. the launcher, ``python -m repro_torch.launch.serve --arch
       qwen1.5-0.5b``, in process."""
    import numpy as np
    import torch
    from repro_torch.config.base import (ARCH_IDS, get_config,
                                         get_smoke_config)
    from repro_torch.kernels import bit_transpose, ref
    from repro_torch.kernels import fused_program as fp
    from repro_torch.models import model as lm
    from repro_torch.models.tree import tree_leaves, tree_map
    on_card = device != "cpu"
    smoke = not on_card
    dev = torch.device(device)
    out = {}
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are enabled: float32 checks would see TF32 error")

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    # -- a. full width bf16 through ServeEngine, three ways -------------- #
    cfg = get_smoke_config(SERVE_ARCH) if smoke else get_config(SERVE_ARCH)
    t = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    sync()
    init_s = time.perf_counter() - t
    n_params = sum(x.numel() for x in tree_leaves(params))
    check(n_params == cfg.param_count(),
          f"{n_params} parameters, count_params says {cfg.param_count()}")
    print(f"serve {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.n_heads} heads, padded vocab {cfg.padded_vocab}, "
          f"{n_params} parameters ({n_params * 4 / 2**30:.2f} GiB float32 "
          f"masters) drawn on {device} in {init_s:.2f} s; compute "
          f"{cfg.dtype}")
    out.update(serve_three_ways(cfg, params, build, dev, "serve"))

    # -- b. full width float32, device against CPU ---------------------- #
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    t = time.perf_counter()
    cpu_params = tree_map(lambda x: x.cpu(), params)
    batch = lm_inputs(cfg32, np.random.default_rng(seed), 2, 16, dev)
    errs, same = lm_parity(cfg32, params, cpu_params, batch, dev, steps=4,
                           forward=False)
    err = max(errs.values())
    print(f"serve {cfg.name} float32, {device} against CPU (prefill 2 x 16 "
          f"tokens, 4 decode steps): max abs logit error {err:.3e} "
          f"(bound {SERVE_F32_TOL:g}; {errs}), greedy tokens "
          f"{'equal' if same else 'DIFFER'}, {time.perf_counter() - t:.1f} s")
    check(err <= SERVE_F32_TOL, f"full-width float32 error {err}")
    check(same, "full-width float32 greedy tokens differ from the CPU")
    out["serve_f32_err"] = err
    del cpu_params, params, batch

    # -- c. the 10 smoke configs, device against CPU, float32 ----------- #
    t = time.perf_counter()
    worst = 0.0
    for arch in ARCH_IDS:
        scfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        cpu_p = lm.init_params(scfg, 0, device="cpu")
        dev_p = tree_map(lambda x: x.to(dev), cpu_p)
        batch = lm_inputs(scfg, np.random.default_rng(seed), 2, 16, dev)
        errs, _ = lm_parity(scfg, dev_p, cpu_p, batch, dev, steps=3,
                            forward=True)
        e = max(errs.values())
        worst = max(worst, e)
        check(e <= SMOKE_F32_TOL, f"{arch} smoke float32: {errs}")
    print(f"smoke configs ({len(ARCH_IDS)} archs, forward + prefill + 3 "
          f"decode steps, float32) on {device} against CPU: max abs logit "
          f"error {worst:.3e} (bound {SMOKE_F32_TOL:g}), "
          f"{time.perf_counter() - t:.1f} s")
    out["smoke_f32_err"] = worst

    # -- d. K1/K2 at the stop predicate's shapes ------------------------ #
    if on_card:
        words = 1   # max_batch 4 lanes -> one 32-lane word per plane
        x1 = torch.randint(-2**31, 2**31 - 1, (32, words), dtype=torch.int32,
                           device=dev)
        e1 = max_abs_err(bit_transpose.bit_transpose32_cuda(x1),
                         ref.bit_transpose32(x1))
        x2 = torch.randint(-2**31, 2**31 - 1,
                           (stop_program.n_inputs, stop_program.width, words),
                           dtype=torch.int32, device=dev)
        e2 = max_abs_err(fp.run_program_cuda(stop_program, x2),
                         fp.run_program_ref(stop_program, x2))
        sync()
        check(e1 == 0 and e2 == 0, f"K1/K2 at the serve shapes: {e1}, {e2}")
        k1 = (cuda_ms(lambda: bit_transpose.bit_transpose32_cuda(x1), 200),
              cuda_ms(lambda: ref.bit_transpose32(x1), 50),
              2 * x1.numel() * 4 / HBM_BYTES_PER_S * 1e3)
        from repro_torch.kernels import codegen
        _, n_ops = codegen.generate(stop_program)
        k2_bytes = 4 * words * stop_program.width * (
            stop_program.n_inputs + len(stop_program.outputs))
        k2 = (cuda_ms(lambda: fp.run_program_cuda(stop_program, x2), 200),
              cuda_ms(lambda: fp.run_program_ref(stop_program, x2), 20),
              max(k2_bytes / HBM_BYTES_PER_S,
                  n_ops * words / ALU_OPS_PER_S) * 1e3)
        print(f"K1 at the serve shape [32, {words}]: bit-exact, through the "
              f"wrapper {k1[0]:.4f} ms, plain {k1[1]:.4f} ms, bound "
              f"{k1[2]:.2e} ms; K2 on the stop predicate ({len(stop_program.ops)} "
              f"ops, [{stop_program.n_inputs}, 32, {words}]): bit-exact, "
              f"through the wrapper {k2[0]:.4f} ms, plain {k2[1]:.4f} ms, "
              f"bound {k2[2]:.2e} ms")
        out["serve_k1"], out["serve_k2"] = k1, k2

    # -- e. the launcher, as a user runs it ----------------------------- #
    serve_launcher(SERVE_ARCH, device)
    return out


TRAIN_ARCH = "qwen1.5-0.5b"      # launch/train.py's documented example
TRAIN_F32_LOSS_RTOL = 1e-5   # float32 loss, card vs CPU, relative
TRAIN_F32_GRAD_TOL = 1e-3    # float32 gradient leaf, card vs CPU, of max|g|
RESUME_LOSS_RTOL = 1e-4      # resumed against uninterrupted step-5 loss
# The float32 card-against-CPU train step runs qwen1.5-0.5b at its full
# width cut to 4 of 24 layers, for time: at 24 layers it took 51.1 s of
# the script's (PERF.md section 4).
TRAIN_F32_LAYERS = 4


def tree_errs(got, want) -> dict:
    """Per leaf (by path), max |got - want| over the leaf's max |want|."""
    from repro_torch.models.tree import tree_items
    out = {}
    for (path, g), (_, w) in zip(tree_items(got), tree_items(want)):
        w = w.detach().float().cpu()
        scale = float(w.abs().max()) or 1.0
        out["/".join(map(str, path))] = float(
            (g.detach().float().cpu() - w).abs().max()) / scale
    return out


def tree_equal(a, b) -> bool:
    """Every leaf of ``a`` equals ``b``'s bit for bit (on the host)."""
    from repro_torch.models.tree import tree_items
    la, lb = tree_items(a), tree_items(b)
    return [p for p, _ in la] == [p for p, _ in lb] and all(
        x.dtype == y.dtype and torch_equal(x, y)
        for (_, x), (_, y) in zip(la, lb))


def torch_equal(x, y) -> bool:
    import torch
    return torch.equal(x.detach().cpu(), y.detach().cpu())


def launcher_run(args: list, device: str) -> tuple:
    """``python -m repro_torch.launch.train`` in a child process (a
    simulated preemption ends the process); returns (exit code, {step:
    loss}, stdout)."""
    import os
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         TRAIN_ARCH, "--device", device] + args, cwd=ROOT,
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    losses = {int(ln.split()[1]): float(ln.split()[3])
              for ln in out.stdout.splitlines() if ln.startswith("step ")}
    check(out.returncode in (0, 42),
          f"launcher {args}: exit {out.returncode}\n{out.stderr[-3000:]}")
    return out.returncode, losses, out.stdout


def lm_train(device: str, build, seed: int) -> dict:
    """The LM train phases on ``device`` (``"cuda"`` on the card; on the
    CPU they rehearse at the arch's smoke config):

    a. ``train_loop`` at qwen1.5-0.5b full width (24 layers, 622,978,048
       parameters, bfloat16 compute over float32 masters, remat on) on
       the launcher's data and schedule (``DataConfig(seq_len=256,
       global_batch=8)``, synthetic; lr 3e-4, warmup 20) for 30 steps:
       losses finite, the mean of the last 5 below the first 5's; step
       ms, tokens/s, peak memory and a ``torch.profiler`` reading of 3
       steady steps;
    b. the same for 5 steps with int8 compression: the ``err`` buffers
       finite and nonzero;
    c. the 1-bit path on one step's full-width gradients: a fused
       ``pum.device(width=32)`` on ``device`` against an eager CPU
       device, wire bitmaps, ``deq`` and ``err`` bit-identical and
       ``EngineStats`` equal; ``pum_sign_majority3`` over the sign
       bitmaps of one leaf's gradients on three seeded batches, the same
       two ways; K1/K2 launch, and are held at the path's largest shapes
       against their plain versions;
    d. a ``CheckpointManager`` round trip of b's state (params, ``mu``,
       ``nu``, ``err``): restored equal bit for bit (free disk checked
       first);
    e. float32 on ``device`` against the CPU: one train step at full width
       and :data:`TRAIN_F32_LAYERS` layers on batch 1 x 17 tokens (loss
       within ``TRAIN_F32_LOSS_RTOL``, each gradient leaf within
       ``TRAIN_F32_GRAD_TOL`` of its max|g|), then
       the 10 smoke configs one step each with int8 compression off and
       on (the same bounds; ``err`` within one int8 quantum more);
    f. the launcher: ``--smoke --steps 12 --ckpt-every 5
       --simulate-preemption 7`` exits 42 with step 5 saved, a rerun
       resumes at 5 and ends at 12 with its step-5 loss within
       ``RESUME_LOSS_RTOL`` of an uninterrupted run; then a few steps at
       full width."""
    import contextlib
    import io
    import shutil
    import numpy as np
    import torch
    import repro_torch.pum as pum
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.config.base import (ARCH_IDS, TrainConfig, get_config,
                                         get_smoke_config)
    from repro_torch.core import engine as engine_mod
    from repro_torch.data.pipeline import (DataConfig, Prefetcher,
                                           SyntheticLM, make_source)
    from repro_torch.kernels import codegen, ops, ref
    from repro_torch.kernels import fused_program as fp
    from repro_torch.launch import train as launch_train
    from repro_torch.models import model as lm
    from repro_torch.models.tree import tree_items, tree_leaves, tree_map
    from repro_torch.train import grad_compress as gc
    from repro_torch.train import trainer
    from repro_torch.train.optimizer import adamw_init
    on_card = device != "cpu"
    dev = torch.device(device)
    out = {}
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are enabled: float32 checks would see TF32 error")

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def free():
        if on_card:
            torch.cuda.empty_cache()

    cfg = get_config(TRAIN_ARCH) if on_card else get_smoke_config(TRAIN_ARCH)
    dcfg = DataConfig(seq_len=256, global_batch=8, vocab_size=cfg.vocab_size)
    tokens_per_step = dcfg.seq_len * dcfg.global_batch

    # -- a. full width, 30 steps --------------------------------------- #
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=20, total_steps=30,
                       checkpoint_every=0)
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    step_s = []
    data = Prefetcher(make_source(dcfg))
    t = time.perf_counter()
    try:
        params, opt, hist = trainer.train_loop(
            cfg, tcfg, data, 30, hooks=trainer.TrainLoopHooks(
                on_step=lambda s, m, dt: step_s.append(dt)), device=dev)
    finally:
        data.close()
    wall = time.perf_counter() - t
    n_params = sum(x.numel() for x in tree_leaves(params))
    check(n_params == cfg.param_count(),
          f"{n_params} parameters, count_params says {cfg.param_count()}")
    losses = [h["loss"] for h in hist]
    check(len(losses) == 30 and all(math.isfinite(x) for x in losses),
          f"train losses {losses}")
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    check(last < first, f"train loss did not fall: {first} -> {last}")
    med = statistics.median(step_s[2:])
    peak = torch.cuda.max_memory_allocated(dev) if on_card else None
    print(f"train {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{n_params} parameters, compute {cfg.dtype}, remat {cfg.remat}; "
          f"30 steps of {dcfg.global_batch} x {dcfg.seq_len} tokens in "
          f"{wall:.1f} s; loss {losses[0]:.4f} -> {losses[-1]:.4f} (mean "
          f"of first 5 {first:.4f}, last 5 {last:.4f}); step "
          f"{med * 1e3:.1f} ms (median of steps 2-29; first "
          f"{step_s[0] * 1e3:.0f} ms), {tokens_per_step / med:.0f} tok/s; "
          f"peak memory allocated "
          + (f"{peak / 2**30:.2f} GiB" if peak is not None else
             "not measured (CPU)"))
    out["train"] = {"losses": losses, "step_ms": med * 1e3,
                    "first_step_ms": step_s[0] * 1e3,
                    "tok_s": tokens_per_step / med, "peak_bytes": peak,
                    "wall_s": wall}
    if on_card:
        step_fn = trainer.build_train_step(cfg, tcfg)
        batches = iter([SyntheticLM(dcfg).batch(30 + i) for i in range(6)])
        state = {"params": params, "opt": opt}

        def one_step():
            state["params"], state["opt"], m = step_fn(
                state["params"], state["opt"],
                trainer.device_batch(next(batches), dev))
            m["loss"].item()

        prof = profile_ticks(one_step, 3)
        out["train_profile"] = prof
        print("train, 3 steady steps under torch.profiler: " + (
            "device time not measured (the profiler saw no device events)"
            if prof is None else
            f"{prof['wall_ms']:.1f} ms/step wall unprofiled "
            f"({prof['profiled_wall_ms']:.1f} profiled), device busy "
            f"{prof['device_ms']:.1f} ms/step, idle share "
            f"{prof['idle_share']:.3f}, {prof['device_ops']:.1f} device "
            f"kernels and copies per step; most frequent (name, per step, "
            f"ms per step): " + "; ".join(
                f"{k} {n:.1f} {ms:.3f}" for k, n, ms in prof["top_ops"])))
        del step_fn, state, batches
    del params, opt
    free()

    # -- b. int8 compression, 5 steps ---------------------------------- #
    tcfg_c = dataclasses.replace(tcfg, grad_compression=True, total_steps=5)
    data = Prefetcher(make_source(dcfg))
    try:
        params, opt, hist = trainer.train_loop(cfg, tcfg_c, data, 5,
                                               device=dev)
    finally:
        data.close()
    errs = tree_leaves(opt["err"])
    nonzero = sum(bool(e.any()) for e in errs)
    check(all(bool(torch.isfinite(e).all()) for e in errs) and nonzero > 0,
          "int8 err buffers not finite or all zero")
    check(all(math.isfinite(h["loss"]) for h in hist), "int8 losses")
    print(f"train int8 compression, 5 steps: loss {hist[0]['loss']:.4f} -> "
          f"{hist[-1]['loss']:.4f}; err buffers finite, {nonzero} of "
          f"{len(errs)} leaves nonzero, max |err| "
          f"{max(float(e.abs().max()) for e in errs):.3e}")

    # -- c. the 1-bit path on the card against the CPU ------------------ #
    small = [np.random.default_rng(seed + i).standard_normal(300)
             .astype(np.float32) for i in range(3)]

    def flows(pdev):
        gc.compress_grads_sign_with_feedback(
            {"g": torch.from_numpy(small[0])},
            {"g": torch.zeros(300)}, device=pdev)
        gc.pum_sign_majority3(*[gc.pack_bitmap(x < 0) for x in small],
                              device=pdev)

    programs = programs_of(engine_mod, lambda: flows(
        pum.device(width=32, fuse=True, device="cpu")))
    if on_card:
        build.build_many(sorted({codegen.build_item(p) for p in programs}))
    grads = trainer.loss_and_grads(cfg, tcfg_c, params, trainer.device_batch(
        SyntheticLM(dcfg).batch(100), dev))[2]
    err = opt["err"]
    shapes = {"bit_transpose32": [], "run_program_cuda": []}
    real_k1, real_k2 = ops.bit_transpose32_cuda, ops.run_program_cuda

    def spy_k1(x):
        shapes["bit_transpose32"].append(tuple(x.shape))
        return real_k1(x)

    def spy_k2(program, x):
        shapes["run_program_cuda"].append((program, tuple(x.shape)))
        return real_k2(program, x)

    wires = {"card": [], "cpu": []}
    real_wire = gc.pum_wire_bitmap

    def run_1bit(label, pdev, g, e):
        def spy_wire(s, m, d=None):
            w = real_wire(s, m, d)
            wires[label].append(w)
            return w
        gc.pum_wire_bitmap = spy_wire
        try:
            t = time.perf_counter()
            res = gc.compress_grads_sign_with_feedback(g, e, device=pdev)
            sync()
            return res, time.perf_counter() - t
        finally:
            gc.pum_wire_bitmap = real_wire

    card_dev = pum.device(width=32, fuse=True, device=dev)
    host_dev = pum.device(width=32, fuse=False, device="cpu")
    reset_launches(build)
    ops.bit_transpose32_cuda, ops.run_program_cuda = spy_k1, spy_k2
    try:
        (cq, ce), card_s = run_1bit("card", card_dev, grads, err)
        leaf_path = ("layers", "mlp", "w_gate")
        votes = []
        for i in range(3):
            g3 = trainer.loss_and_grads(cfg, tcfg_c, params,
                                        trainer.device_batch(
                                            SyntheticLM(dcfg).batch(200 + i),
                                            dev))[2]
            votes.append(gc.pack_bitmap(
                (dict(tree_items(g3))[leaf_path] < 0).cpu().numpy()))
            del g3
        t = time.perf_counter()
        maj_card = gc.pum_sign_majority3(*votes, device=card_dev)
        maj_card_s = time.perf_counter() - t
    finally:
        ops.bit_transpose32_cuda, ops.run_program_cuda = real_k1, real_k2
    launches = {k: build.LAUNCHES.get(k, 0) for k in K12}
    out["train_launches"] = launches
    (hq, he), host_s = run_1bit("cpu", host_dev,
                                tree_map(lambda x: x.cpu(), grads),
                                tree_map(lambda x: x.cpu(), err))
    t = time.perf_counter()
    maj_host = gc.pum_sign_majority3(*votes, device=host_dev)
    maj_host_s = time.perf_counter() - t
    check(len(wires["card"]) == len(wires["cpu"]) == len(tree_leaves(grads))
          and all(np.array_equal(a, b)
                  for a, b in zip(wires["card"], wires["cpu"])),
          "1-bit wire bitmaps differ between the card and the CPU")
    check(tree_equal(cq, hq) and tree_equal(ce, he),
          "1-bit deq/err differ between the card and the CPU")
    check(all(x.device.type == dev.type for x in tree_leaves(cq)),
          "1-bit deq did not come back onto the gradients' device")
    check(np.array_equal(maj_card, maj_host),
          "pum_sign_majority3 differs between the card and the CPU")
    want_maj = (votes[0] & votes[1]) | (votes[1] & votes[2]) | \
        (votes[0] & votes[2])
    check(np.array_equal(maj_host, want_maj), "MAJ3 differs from NumPy")
    check(card_dev.stats.as_dict() == host_dev.stats.as_dict(),
          f"1-bit EngineStats differ: {card_dev.stats} vs {host_dev.stats}")
    if on_card:
        check(all(launches[k] > 0 for k in K12),
              f"1-bit path: launches {launches}")
    n_words = sum(len(w) for w in wires["card"])
    print(f"train 1-bit path on {device} (fused) against an eager CPU "
          f"device: {len(wires['card'])} gradient leaves, {n_words} wire "
          f"words, wire bitmaps, deq and err bit-identical, EngineStats "
          f"equal ({card_dev.stats.latency_ns} ns modeled); "
          f"pum_sign_majority3 over {'/'.join(leaf_path)} sign bitmaps of "
          f"3 seeded batches ({len(votes[0])} words) equal on both and to "
          f"NumPy; wall {card_s:.2f} s card / {host_s:.2f} s CPU "
          f"(MAJ3 {maj_card_s:.3f} / {maj_host_s:.3f} s); K1/K2 launches "
          f"{launches}")
    if on_card:
        g = max(shapes["bit_transpose32"], key=lambda s: s[1])
        x1 = torch.randint(-2**31, 2**31 - 1, g, dtype=torch.int32,
                           device=dev)
        e1 = max_abs_err(ops.bit_transpose32(x1), ref.bit_transpose32(x1))
        prog, s2 = max(shapes["run_program_cuda"], key=lambda p: p[1][2])
        x2 = torch.randint(-2**31, 2**31 - 1, s2, dtype=torch.int32,
                           device=dev)
        e2 = max_abs_err(fp.run_program_cuda(prog, x2),
                         fp.run_program_ref(prog, x2))
        sync()
        check(e1 == 0 and e2 == 0, f"K1/K2 at the train shapes: {e1}, {e2}")
        _, n_ops = codegen.generate(prog)
        k2_bytes = 4 * s2[2] * prog.width * (prog.n_inputs
                                             + len(prog.outputs))
        # Device time through the wrappers, inputs rotated past 128 MiB
        # (benchmarks/torch_kernel_bench.py::device_us).
        from benchmarks.torch_kernel_bench import device_us
        out["train_k1"] = (
            device_us(ops.bit_transpose32, (x1,), 3) / 1e3,
            cuda_ms(lambda: ref.bit_transpose32(x1), 3, rounds=3),
            2 * x1.numel() * 4 / HBM_BYTES_PER_S * 1e3, g)
        out["train_k2"] = (
            device_us(lambda x: fp.run_program_cuda(prog, x), (x2,), 3)
            / 1e3,
            cuda_ms(lambda: fp.run_program_ref(prog, x2), 3, rounds=3),
            max(k2_bytes / HBM_BYTES_PER_S,
                n_ops * s2[2] / ALU_OPS_PER_S) * 1e3, s2)
        for name, (ms, plain, bound, shape) in (
                ("K1", out["train_k1"]),
                (f"K2 ({len(prog.ops)} ops)", out["train_k2"])):
            print(f"{name} at the train path's largest shape {list(shape)}: "
                  f"bit-exact, {ms:.4f} ms a launch on the rotated device "
                  f"timer, plain {plain:.4f} ms, bound {bound:.4f} ms, "
                  f"{bound / ms:.0%} of it")
        del x1, x2
    del grads, cq, ce, hq, he, votes

    # -- d. checkpoint round trip at full width ------------------------ #
    ck_dir = ROOT / "build" / "lm_train_ckpt"
    shutil.rmtree(ck_dir, ignore_errors=True)
    ck_dir.mkdir(parents=True)
    need = sum(x.numel() * x.element_size()
               for x in tree_leaves(params) + tree_leaves(opt))
    free_b = shutil.disk_usage(ck_dir).free
    check(free_b > 1.2 * need, f"checkpoint needs {need} bytes, {free_b} "
                               f"free under {ck_dir}")
    try:
        mgr = CheckpointManager(str(ck_dir))
        t = time.perf_counter()
        mgr.save(5, params, opt)
        copy_s = time.perf_counter() - t
        mgr.wait()
        save_s = time.perf_counter() - t
        written = sum(f.stat().st_size for f in ck_dir.rglob("*")
                      if f.is_file())
        t = time.perf_counter()
        p2, o2, meta = mgr.restore(5, params, opt)
        sync()
        restore_s = time.perf_counter() - t
        check(meta["step"] == 5 and tree_equal(p2, params)
              and tree_equal(o2, opt),
              "checkpoint restore differs from the saved state")
        check(all(x.device.type == dev.type for x in tree_leaves(p2)),
              "checkpoint restored onto the wrong device")
    finally:
        shutil.rmtree(ck_dir, ignore_errors=True)
    print(f"train checkpoint (params, mu, nu, err; {need} bytes of state, "
          f"{written} bytes written): restored bit for bit on {device}; save "
          f"{save_s:.1f} s (device-to-host copy {copy_s:.1f} s, free "
          f"{free_b / 2**30:.0f} GiB), restore {restore_s:.1f} s")
    out["train_ckpt"] = {"bytes": written, "save_s": save_s,
                         "copy_s": copy_s, "restore_s": restore_s}
    del params, opt, p2, o2, errs
    free()

    # -- e. float32, device against the CPU ----------------------------- #
    def f32_step(c, cpu_p, batch, compression):
        """(loss rel error, worst gradient leaf error, worst err leaf
        error in quanta) of one float32 train step of ``c`` on the
        device against the CPU, from the same params."""
        t_cfg = TrainConfig(grad_compression=compression, warmup_steps=1)
        dev_p = tree_map(lambda x: x.detach().to(dev), cpu_p)
        hb = trainer.device_batch(batch, "cpu")
        db = trainer.device_batch(batch, dev)
        _, _, want = trainer.loss_and_grads(c, t_cfg, cpu_p, hb)
        _, _, got = trainer.loss_and_grads(c, t_cfg, dev_p, db)
        g_err = max(tree_errs(got, want).values())
        ho = adamw_init(cpu_p)
        if compression:
            ho["err"] = gc.init_error(cpu_p)
        do = tree_map(lambda x: x.to(dev), ho)
        step = trainer.build_train_step(c, t_cfg)
        _, ho, hm = step(cpu_p, ho, hb)
        _, do, dm = step(dev_p, do, db)
        l_err = abs(float(dm["loss"]) - float(hm["loss"])) / abs(
            float(hm["loss"]))
        e_err = 0.0
        if compression:
            for (path, a), (_, b), (_, w) in zip(
                    tree_items(do["err"]), tree_items(ho["err"]),
                    tree_items(want)):
                m = float(w.abs().max()) or 1.0
                d = float((a.cpu() - b).abs().max())
                e_err = max(e_err, d / (m * (1 / 127 + TRAIN_F32_GRAD_TOL)))
        return l_err, g_err, e_err

    t = time.perf_counter()
    cfg32 = dataclasses.replace(cfg, dtype="float32", n_layers=min(
        TRAIN_F32_LAYERS, cfg.n_layers))
    cpu_p = lm.init_params(cfg32, 0, device="cpu")
    batch = {"tokens": np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, 17)).astype(np.int32)}
    l_err, g_err, _ = f32_step(cfg32, cpu_p, batch, False)
    print(f"train {cfg.name} float32 at {cfg32.n_layers} of {cfg.n_layers} "
          f"layers, {device} against CPU (one train step, "
          f"1 x 17 tokens): loss rel error {l_err:.2e} (bound "
          f"{TRAIN_F32_LOSS_RTOL:g}), worst gradient leaf {g_err:.2e} of its "
          f"max|g| (bound {TRAIN_F32_GRAD_TOL:g}), "
          f"{time.perf_counter() - t:.1f} s")
    check(l_err <= TRAIN_F32_LOSS_RTOL and g_err <= TRAIN_F32_GRAD_TOL,
          f"full-width float32 train step: loss {l_err}, grads {g_err}")
    out["train_f32"] = (l_err, g_err)
    del cpu_p
    t = time.perf_counter()
    worst = [0.0, 0.0, 0.0]
    for arch in ARCH_IDS:
        scfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        sb = SyntheticLM(DataConfig(seq_len=16, global_batch=2,
                                    vocab_size=scfg.vocab_size)).batch(0)
        sb.update({k: v.cpu().numpy() for k, v in lm_inputs(
            scfg, np.random.default_rng(seed), 2, 16, "cpu").items()
            if k != "tokens"})
        for compression in (False, True):
            e = f32_step(scfg, lm.init_params(scfg, 0, device="cpu"), sb,
                         compression)
            check(e[0] <= TRAIN_F32_LOSS_RTOL and e[1] <= TRAIN_F32_GRAD_TOL
                  and e[2] <= 1.0,
                  f"{arch} smoke float32 train step (compression "
                  f"{compression}): {e}")
            worst = [max(a, b) for a, b in zip(worst, e)]
    print(f"train smoke configs ({len(ARCH_IDS)} archs x int8 compression "
          f"off/on, one float32 step) on {device} against CPU: loss rel "
          f"error {worst[0]:.2e}, worst gradient leaf {worst[1]:.2e} of its "
          f"max|g|, err within {worst[2]:.2f} of (1/127 + "
          f"{TRAIN_F32_GRAD_TOL:g}) max|g|, {time.perf_counter() - t:.1f} s")
    out["train_smoke_f32"] = worst

    # -- f. the launcher: preemption, resume, full width --------------- #
    ck_dir.mkdir(parents=True)
    try:
        base = ["--smoke", "--log-every", "1", "--steps", "12",
                "--ckpt-every", "5"]
        t = time.perf_counter()
        rc, pre, _ = launcher_run(base + ["--ckpt-dir", str(ck_dir / "a"),
                                          "--simulate-preemption", "7"],
                                  device)
        saved = CheckpointManager(str(ck_dir / "a")).all_steps()
        check(rc == 42 and saved == [5] and sorted(pre) == list(range(7)),
              f"preempted launcher: exit {rc}, saved {saved}, steps "
              f"{sorted(pre)}")
        rc, res, res_out = launcher_run(base + ["--ckpt-dir",
                                                str(ck_dir / "a")], device)
        check(rc == 0 and sorted(res) == list(range(5, 12)),
              f"resumed launcher: exit {rc}, steps {sorted(res)}")
        rc, full, _ = launcher_run(base + ["--ckpt-dir", str(ck_dir / "b")],
                                   device)
        check(rc == 0 and sorted(full) == list(range(12)),
              f"uninterrupted launcher: exit {rc}, steps {sorted(full)}")
        rel = abs(res[5] - full[5]) / abs(full[5])
        check(rel <= RESUME_LOSS_RTOL,
              f"resumed step-5 loss {res[5]} against {full[5]}")
    finally:
        shutil.rmtree(ck_dir, ignore_errors=True)
    print(f"train launcher (--smoke): --simulate-preemption 7 exited 42 with "
          f"step 5 saved; the rerun resumed at 5 and ended at 12 "
          f"({res_out.strip().splitlines()[-1]}); step-5 loss {res[5]:.4f} "
          f"against {full[5]:.4f} uninterrupted (rel {rel:.1e}, bound "
          f"{RESUME_LOSS_RTOL:g}), step-11 {res[11]:.4f} against "
          f"{full[11]:.4f}; {time.perf_counter() - t:.1f} s for 3 runs")
    argv = ["--arch", TRAIN_ARCH, "--steps", "3", "--log-every", "1",
            "--device", device] + ([] if on_card else ["--smoke"])
    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        check(launch_train.main(argv) == 0, "the train launcher failed")
    lines = buf.getvalue().strip().splitlines()
    check(lines[-1].startswith(f"[train] {TRAIN_ARCH}: loss")
          and "over 3 steps" in lines[-1], f"launcher printed {lines}")
    print(f"launcher (python -m repro_torch.launch.train "
          f"{' '.join(argv)}), {time.perf_counter() - t:.1f} s: "
          + " | ".join(lines))
    return out


LAUNCH_ARCH = "qwen1.5-0.5b"    # the cells' model: the launchers' example
# (shape, global batch kept on one card, layers; None keeps the depth):
# each shape's sequence length is kept; only its global batch is cut to
# what one 80 GB card holds, and prefill_32k's depth to 8 of the 24
# layers to keep the script inside its time limit (PERF.md section 4;
# 8.3 s a call at 24).
LAUNCH_CUTS = (("train_4k", 2, None), ("prefill_32k", 1, 8),
               ("decode_32k", 8, None))


def launch_and_shard(device: str, build, seed: int) -> dict:
    """Phase 22 (``launch_and_shard``) on ``device`` (``"cuda"`` on the
    card; on the CPU it rehearses with 4096 lanes, the arch's smoke config
    and sequence lengths of 16): :func:`shard_words_run`, then
    :func:`lm_cells_run`."""
    out = shard_words_run(device, build, seed)
    out.update(lm_cells_run(device, seed))
    return out


def shard_words_run(device: str, build, seed: int) -> dict:
    """prog16 at 2M lanes through ``pum.device(fused_backend=
    "shard-words")`` over every visible card (one shard on a one-card
    host): bit-exact against NumPy, a ``vertical-cuda`` device and a CPU
    device, ``EngineStats`` equal; K1/K2 launches counted per card
    (n_inputs + n_outputs and 1 per flush on each), the warm flush's wall
    and ``flush.*`` spans beside the ``vertical-cuda`` device's."""
    import numpy as np
    import torch
    import repro_torch.pum as pum
    from repro_torch.distributed.sharding import words_mesh
    from repro_torch.kernels import ops
    on_card = device != "cpu"
    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    out = {}

    n = (1 << 21) if on_card else 4096
    ops16 = [rng.integers(0, 2**32, n, dtype=np.uint64) for _ in range(3)]
    want = prog16_numpy(*ops16)
    cards = words_mesh().devices if on_card else (dev,)
    per_card = collections.Counter()
    real = {"bit_transpose32": ops.bit_transpose32_cuda,
            "run_program_cuda": ops.run_program_cuda}

    def counted(name):
        def launch(*args):
            x = args[-1] if name == "run_program_cuda" else args[0]
            per_card[(x.device.index, name)] += 1
            return real[name](*args)
        return launch

    results = {}
    for label, kw in (("shard-words", {"fused_backend": "shard-words"}),
                      ("vertical-cuda", {}),
                      ("cpu", {"device": "cpu"})):
        if not on_card and label != "cpu":
            kw = dict(kw, device="cpu")
        d = pum.device(**kw)
        reset_launches(build)
        per_card.clear()
        ops.bit_transpose32_cuda = counted("bit_transpose32")
        ops.run_program_cuda = counted("run_program_cuda")
        try:
            t = time.perf_counter()
            cold = prog16(d, *ops16).to_numpy()
            cold_s = time.perf_counter() - t
            with pum.profile(d) as tr:
                t = time.perf_counter()
                warm = prog16(d, *ops16).to_numpy()
                warm_s = time.perf_counter() - t
        finally:
            ops.bit_transpose32_cuda = real["bit_transpose32"]
            ops.run_program_cuda = real["run_program_cuda"]
        check(np.array_equal(cold, want) and np.array_equal(warm, want),
              f"prog16 {n} lanes on {label}: differs from NumPy")
        prog = d.engine.last_program
        results[label] = {
            "stats": d.stats.as_dict(), "cold_s": cold_s, "warm_s": warm_s,
            "spans": span_ms(tr), "launches": dict(build.LAUNCHES),
            "per_card": dict(per_card),
            "k1_per_flush": prog.n_inputs + len(prog.outputs)}
        d.close()
    for label in ("vertical-cuda", "cpu"):
        check(results[label]["stats"] == results["shard-words"]["stats"],
              f"shard-words: EngineStats differ from the {label} device "
              f"({results['shard-words']['stats']} vs "
              f"{results[label]['stats']})")
    sw = results["shard-words"]
    if on_card:
        for i, card in enumerate(cards):
            k1 = sw["per_card"].get((card.index, "bit_transpose32"), 0)
            k2 = sw["per_card"].get((card.index, "run_program_cuda"), 0)
            check((k1, k2) == (2 * sw["k1_per_flush"], 2),
                  f"shard-words: card {card} launched K1/K2 {k1}/{k2} over "
                  f"2 flushes, want {2 * sw['k1_per_flush']}/2")
        check(sum(sw["launches"].get(k, 0) for k in K12)
              == len(cards) * 2 * (sw["k1_per_flush"] + 1),
              f"shard-words: launches {sw['launches']}")
    print(f"shard-words prog16 {n} lanes over {len(cards)} "
          f"{'card' if len(cards) == 1 else 'cards'} "
          f"({', '.join(str(c) for c in cards)}): bit-exact vs NumPy, "
          f"vertical-cuda and a CPU device, EngineStats equal "
          f"{sw['stats']}")
    for label in ("shard-words", "vertical-cuda", "cpu"):
        r = results[label]
        card_counts = "; ".join(
            f"{label} card {c.index}: K1/K2 "
            f"{r['per_card'].get((c.index, 'bit_transpose32'), 0) // 2}/"
            f"{r['per_card'].get((c.index, 'run_program_cuda'), 0) // 2} "
            f"per flush" for c in cards) if on_card and label != "cpu" \
            else f"{label}: no kernel launch"
        print(f"  {label}: first flush {r['cold_s']:.4f} s, warm "
              f"{r['warm_s'] * 1e3:.1f} ms; {card_counts}; launches "
              f"{r['launches']} (2 flushes); warm spans (ms): "
              + ", ".join(f"{k} {v:.3f}" for k, v in r["spans"].items()))
    out["shard_launches"] = sw["launches"]
    out["shard_warm_ms"] = sw["warm_s"] * 1e3
    out["vertical_warm_ms"] = results["vertical-cuda"]["warm_s"] * 1e3
    return out


def _free(on_card: bool) -> None:
    """Return the card's freed memory, tensors held in reference cycles
    (a closed ServeEngine's params, a cell's arguments) included."""
    if on_card:
        import torch
        gc.collect()
        torch.cuda.empty_cache()


def _stamper(phase: str):
    """A ``stamp(step)`` that prints ``[time] phase PHASE STEP`` with the
    seconds since its last call (or since this one)."""
    last = [time.perf_counter()]

    def stamp(step: str) -> None:
        now = time.perf_counter()
        print(f"[time] phase {phase} {step}: {now - last[0]:.1f} s",
              flush=True)
        last[0] = now
    return stamp


def run_cells(arch: str, cuts, device: str, seed: int) -> dict:
    """``arch``'s cells through ``steps.build_cell(..., make_test_mesh(1))``
    at full width (weights from a ``torch.Generator`` seeded 0), each
    shape's sequence length kept and its global batch cut as ``cuts``
    says ((shape, batch) pairs, or (shape, batch, layers) where the depth
    is cut too: the cell is built from, and bounded by, the config with
    that many layers, in each stack of an encoder-decoder): the tensors
    given to the cell are the dry run's ``meta`` arguments made real,
    their bytes equal to its
    ``argument_size_in_bytes`` on the 1x1 mesh, and the outputs finite;
    prints each cell's cold and warm wall (each ending in a read-back),
    peak memory, the dry run's counted FLOPs at the cut shape, the
    roofline's one-card bound and wall / bound, and on the card one
    profiled call (device busy, idle share, device ops). On the CPU it
    rehearses at the smoke config with sequences of 16 (after a VLM's
    patch prefix)."""
    import torch
    from repro_torch.config.base import (LM_SHAPES, ShapeConfig, get_config,
                                         get_smoke_config)
    from repro_torch.launch import dryrun, roofline, steps
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.tree import tree_leaves
    on_card = device != "cpu"
    dev = torch.device(device)
    out = {}

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    full = get_config(arch) if on_card else get_smoke_config(arch)
    # One card's 1x1 mesh: the cut cells run unsharded on it.
    mesh = make_test_mesh(1) if on_card else make_test_mesh(devices=[dev])
    real_get_config = steps.get_config
    try:
        for name, cut, *depth in cuts:
            t_cell = time.perf_counter()
            # the rehearsal builds the smoke config through the same path;
            # an encoder-decoder's cut applies to both of its stacks
            cfg = full if not depth or depth[0] is None else \
                dataclasses.replace(full, n_layers=min(depth[0],
                                                       full.n_layers),
                                    n_encoder_layers=min(
                                        depth[0], full.n_encoder_layers))
            steps.get_config = lambda arch, cfg=cfg: cfg
            g = LM_SHAPES[name]
            # the rehearsal: 16 tokens after a smoke VLM's patch prefix
            seq = g.seq_len if on_card else 16 + (
                cfg.n_frontend_tokens if cfg.frontend == "vision" else 0)
            shape = ShapeConfig(name, g.kind, seq, cut)
            cell = steps.build_cell(arch, shape, mesh)
            rec = dryrun.trace_cell(cell, mesh)
            before = torch.cuda.memory_allocated(dev) if on_card else 0
            args = lm_cell_args(cell, cfg, dev, seed)
            metas, reals = tree_leaves(cell.args), tree_leaves(args)
            check(len(metas) == len(reals) and all(
                tuple(m.shape) == tuple(r.shape) and m.dtype == r.dtype
                for m, r in zip(metas, reals)),
                f"{name}: real arguments differ from the cell's specs")
            given = sum(t.numel() * t.element_size() for t in reals)
            check(given == rec["memory"]["argument_size_in_bytes"],
                  f"{name}: {given} bytes given, the dry run says "
                  f"{rec['memory']['argument_size_in_bytes']}")
            walls = []
            for _ in range(2):
                res = None  # the cold call's outputs do not count at peak
                if on_card:
                    torch.cuda.reset_peak_memory_stats(dev)
                sync()
                t = time.perf_counter()
                res = cell.fn(*args)
                # read back: a train step's metrics, the serving logits
                host = [v.float().cpu() for v in (
                    res[2].values() if g.kind == "train" else res[:1])]
                walls.append(time.perf_counter() - t)
            peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
            check(all(all_finite(x) for x in host + tree_leaves(res)
                      if x.is_floating_point()),
                  f"{name}: non-finite outputs")
            bound = one_card_bound(roofline, cfg, name, cut)
            size = "full width" if on_card else "smoke"
            if cfg.encoder_decoder and cfg.n_layers != full.n_layers:
                size += (f", {cfg.n_encoder_layers} + {cfg.n_layers} of "
                         f"{full.n_encoder_layers} + {full.n_layers} layers")
            elif cfg.n_layers != full.n_layers:
                size += f", {cfg.n_layers} of {full.n_layers} layers"
            print(f"{name} cut to batch {cut} x {seq} ({g.global_batch} "
                  f"global), {arch} {size}: {given:,} argument "
                  f"bytes on the card = the dry run's; "
                  f"outputs finite; wall {walls[0]:.3f} s cold, "
                  f"{walls[1]:.3f} s warm; peak memory "
                  f"{peak / 2**30:.2f} GiB ({before / 2**30:.2f} "
                  f"allocated before the arguments); dry run "
                  f"{rec['flops'] / 1e12:.3f} TFLOP counted (trace {rec['lower_compile_s']} s); "
                  f"one-card bound {bound['bound_s'] * 1e3:.2f} ms, wall / "
                  f"bound {walls[1] / bound['bound_s']:.1f} "
                  f"(compute {bound['compute_s'] * 1e3:.2f}, memory "
                  f"{bound['memory_s'] * 1e3:.2f}; analytic "
                  f"{bound['flops'] / 1e12:.3f} TFLOP)")
            if cfg.encoder_decoder:
                left = encdec_flops(cfg, name, cut)
                bound.update(left)
                print(f"  {name}: the roofline counts no cross-attention "
                      f"({left['xattn_flops'] / 1e12:.3f} TFLOP here) and "
                      f"its encoder term is "
                      f"{left['encoder_counted_flops'] / 1e12:.3f} TFLOP "
                      f"where the encoder runs "
                      f"{left['encoder_flops'] / 1e12:.3f} TFLOP")
            if on_card:
                prof = profile_ticks(lambda: cell.fn(*args), 1,
                                     wall_ms=walls[1] * 1e3)
                check(prof is not None, f"{name}: the profiler saw no "
                      f"device events")
                print(f"  {name} under torch.profiler (1 call): "
                      f"{prof['wall_ms']:.1f} ms unprofiled "
                      f"({prof['profiled_wall_ms']:.1f} profiled), device "
                      f"busy {prof['device_ms']:.1f} ms, idle share "
                      f"{prof['idle_share']:.3f}, {prof['device_ops']:.0f} "
                      f"device ops; longest (name, count, ms): "
                      + "; ".join(f"{k} {n:.0f} {ms:.1f}"
                                  for k, n, ms in prof["top_time"]))
                out[f"{name}_profile"] = prof
            out[name] = {"warm_s": walls[1], "cold_s": walls[0],
                         "peak_gib": peak / 2**30, "layers": cfg.n_layers,
                         "dry_run_flops": rec["flops"],
                         "arg_bytes": given, **bound}
            del cell, args, res, host, reals
            _free(on_card)
            print(f"  {name}: {time.perf_counter() - t_cell:.1f} s in all "
                  f"(build, dry-run trace, arguments, calls, checks)")
    finally:
        steps.get_config = real_get_config

    return out


def lm_cells_run(device: str, seed: int) -> dict:
    """qwen1.5-0.5b's ``train_4k``, ``prefill_32k`` and ``decode_32k``
    cells at full width (24 layers, d 1024, padded vocab 153,600), their
    batches cut to :data:`LAUNCH_CUTS` (:func:`run_cells`); then the
    analytic dry run of the three cells on the 16x16 production mesh
    (host only)."""
    from repro_torch.launch import dryrun, roofline
    out = run_cells(LAUNCH_ARCH, LAUNCH_CUTS, device, seed)

    # the analytic dry run on 16x16 (host)
    t = time.perf_counter()
    for name, *_ in LAUNCH_CUTS:
        rec = dryrun.run_cell(LAUNCH_ARCH, name, False)
        p = roofline.analyze_record(rec)
        print(f"dry run {LAUNCH_ARCH} x {name} x {rec['mesh']}: "
              f"{rec['flops'] / 1e12:.3f} TFLOP per device counted "
              f"({rec['flops'] * rec['n_devices'] / 1e12:.1f} global; "
              f"analytic {p.analytic_flops_total / 1e12:.1f}), "
              f"{rec['memory']['argument_size_in_bytes']:,} argument bytes "
              f"per device, trace {rec['lower_compile_s']} s; collective "
              f"census ({rec['census_s']} s) "
              + (", ".join(f"{k} {v:,.0f} B" for k, v in
                           rec["collectives"].items())
                 if rec["collectives"] else
                 f"failed: {rec.get('collectives_error')}")
              + f"; roofline compute {p.compute_s * 1e3:.3f} ms, memory "
              f"{p.memory_s * 1e3:.3f} ms, collective "
              f"{p.collective_s * 1e3:.3f} ms ({p.dominant})")
    print(f"dry run on 16x16: {time.perf_counter() - t:.1f} s")
    return out


def all_finite(x) -> bool:
    """Whether every value of ``x`` is finite, checked 2**27 values at a
    time (a whole-cache mask would take GiBs)."""
    import torch
    return all(bool(torch.isfinite(t).all())
               for t in x.reshape(-1).split(1 << 27))


def lm_cell_args(cell, cfg, dev, seed: int, place=None) -> tuple:
    """Real tensors for a cell's ``meta`` arguments on ``dev``: the
    parameters drawn by ``init_params`` from a ``torch.Generator`` seeded
    0 in the specs' dtype (a serving cell's bfloat16 weights are drawn
    in bfloat16, a layer slice at a time), AdamW state as zeros (step
    0), decode caches as standard normal values from a generator seeded
    ``seed + 1`` (every ring slot holds a key and a value the step
    attends to), token ids and positions, audio frames (normal, 0.02) and
    an encoder memory (normal) from a generator seeded ``seed``.
    ``place(x, sharding)``, when given, takes each state or cache leaf as
    it is made (a sharded run keeps only its rank's part)."""
    import torch
    from repro_torch.models import model as lm
    from repro_torch.models.tree import tree_leaves, tree_map
    place = place or (lambda x, _sharding: x)
    dtype = tree_leaves(cell.args[0])[0].dtype
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev,
                            dtype=None if dtype == torch.float32 else dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(spec, scale=1.0):
        return torch.randn(spec.shape, generator=gen, device=dev,
                           dtype=torch.float32).mul_(scale).to(spec.dtype)

    def batch(specs):
        return {k: torch.randint(0, cfg.vocab_size, v.shape, generator=gen,
                                 device=dev, dtype=v.dtype)
                if k == "tokens" else normal(v, 0.02)
                for k, v in specs.items()}

    kind = cell.shape.kind
    if kind == "train":
        return (params, tree_map(lambda spec, sh: place(torch.zeros(
                    spec.shape, dtype=spec.dtype, device=dev), sh),
                    cell.args[1], cell.in_shardings[1]),
                batch(cell.args[2]))
    if kind == "prefill":
        return params, batch(cell.args[1])
    fill = torch.Generator(device=dev).manual_seed(seed + 1)
    caches = tree_map(lambda spec, sh: place(torch.randn(
        spec.shape, generator=fill, dtype=spec.dtype, device=dev), sh),
        cell.args[1], cell.in_shardings[1])
    tok, pos = cell.args[2], cell.args[3]
    token = torch.randint(0, cfg.vocab_size, tok.shape, generator=gen,
                          device=dev, dtype=tok.dtype)
    # The last slot of the ring: every position of the cache attended.
    position = torch.full(pos.shape, cell.shape.seq_len - 1,
                          dtype=pos.dtype, device=dev)
    if len(cell.args) == 5:   # the encoder-decoder's memory
        return (params, caches, token, position,
                place(normal(cell.args[4]), cell.in_shardings[4]))
    return params, caches, token, position


class _NoWeights:
    """``cfg`` with no parameters: the roofline, asked about it, counts
    activations and caches but no weights."""

    def __init__(self, cfg):
        self._cfg = cfg

    def __getattr__(self, name):
        return getattr(self._cfg, name)

    def param_count(self) -> int:
        return 0


def weights_read(cfg, tokens: int) -> int:
    """The parameters of ``cfg`` that a step over ``tokens`` tokens must
    read: all of them, but in each MoE layer only the routed experts that
    ``tokens * top_k`` choices can reach, ``min(n_experts, tokens *
    top_k)`` (the analytic FLOPs count ``top_k`` experts a token). A
    decode step of a few sequences reaches a few experts; a prefill or a
    train step reaches them all."""
    n = cfg.param_count()
    if not cfg.moe:
        return n
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.init import Draw
    experts = moe_mod.moe_params(Draw(None, "meta"), cfg)
    per_expert = sum(experts[k].numel() for k in ("w_gate", "w_up",
                                                  "w_down")) // cfg.n_experts
    unread = cfg.n_experts - min(cfg.n_experts, tokens * cfg.top_k)
    return n - (cfg.n_layers - cfg.first_dense_layers) * per_expert * unread


def one_card_bound(roofline, cfg, name: str, cut: int) -> dict:
    """The roofline's least time for ``cfg`` (a config that may be cut in
    depth; the roofline reads it in place of its arch's) in a cell cut
    to ``cut`` sequences on one card: the analytic FLOPs scaled by
    ``cut`` over the global batch at ``PEAK_FLOPS``, against bytes at
    ``HBM_BW``: the roofline's activations and caches of one device
    holding ``cut`` sequences (``global_batch / cut`` devices, no model
    axis), and the weights that the one card holds and the step reads
    (:func:`weights_read`), 2 bytes each serving and ``2 * 2 + 4 * 7``
    training (bfloat16 reads, the float32 gradient and AdamW). The
    roofline's own weight term is left out: its rule for a production
    mesh shards the weights over the devices past 12e9 bytes."""
    from repro_torch.config.base import LM_SHAPES
    shape = LM_SHAPES[name]
    gb = shape.global_batch
    real_get_config = roofline.get_config
    roofline.get_config = lambda _arch: _NoWeights(cfg)
    try:
        flops = roofline.analytic_flops(cfg.name, name) * cut / gb
        rest = roofline.analytic_bytes_per_chip(cfg.name, name, gb // cut,
                                                msize=1)
    finally:
        roofline.get_config = real_get_config
    train = shape.kind == "train"
    tokens = cut * (1 if shape.kind == "decode" else shape.seq_len)
    nbytes = rest + (2 * 2 + 4 * 7 if train else 2) * weights_read(cfg,
                                                                   tokens)
    compute, memory = flops / roofline.PEAK_FLOPS, nbytes / roofline.HBM_BW
    return {"flops": flops, "bytes": nbytes, "compute_s": compute,
            "memory_s": memory, "bound_s": max(compute, memory)}


# output -> (rtol, atol) of the reference's checks of a sharded run
# (tests/distributed/test_multidevice.py): the bfloat16 train step's loss
# and float32 parameters, and (its MoE check's) the serving logits and
# caches.
SHARDED_TOL = {"loss": (1e-3, 0.0), "params": (5e-3, 1e-4),
               "logits": (2e-3, 2e-5), "caches": (2e-3, 2e-5)}
# output -> the largest |a - b| / max |b| of any leaf a run across ranks
# may show. The serving logits and caches are bfloat16, whose sums a
# sharded run reorders: one rounding apart is 2**-8 of a value, above the
# rtol of SHARDED_TOL, so they are held at eight roundoff units of the
# output's largest magnitude (the element-wise ratio to SHARDED_TOL is
# reported). The train step's gradients, read through the AdamW moments
# of the first step (mu = 0.1 g, nu = 0.05 g**2; its learning rate is 0,
# so the parameters cannot show them) and the global norm, come from
# bfloat16 products whose partial sums the data shards round apart: held
# at 2**-3 of each leaf's largest magnitude. Each planted fault of
# SHARDED_FAULTS (a sum over ranks skipped) must read above a limit, and
# the phase fails if one does not.
SHARDED_MAX_REL = {"logits": 2.0 ** -5, "caches": 2.0 ** -5,
                   "grad_norm": 2.0 ** -3, "mu": 2.0 ** -3, "nu": 2.0 ** -3}
# fault (see _plant) -> the cells its control run repeats (across ranks
# only: on one rank nothing is summed over ranks)
SHARDED_FAULTS = {"grad_sums_kept": ("train_4k",),
                  "partial_sums_kept": ("decode_32k",)}
# On one card (the (1, 1) mesh) the cells run qwen1.5-0.5b at its full
# width cut to 4 of 24 layers, for time: at 24 layers the phase took
# 115.6 s of the script's, 52.0 s of it the 1-bit path on the gradients
# (PERF.md section 4). Across cards the depth is kept.
SHARDED_ONE_CARD_LAYERS = 4


def lm_cells_sharded(device: str, build, seed: int,
                     ranks: int | None = None) -> dict:
    """Phase 23 (``lm_cells_sharded``): qwen1.5-0.5b's ``train_4k``,
    ``prefill_32k`` and ``decode_32k`` cells executed across one rank per
    visible card (on one card at :data:`SHARDED_ONE_CARD_LAYERS` layers;
    ``ranks`` CPU ranks on ``gloo`` when ``device`` is the CPU, at the
    smoke config and sequence length 16) as DTensors under
    their shardings, through ``launch.steps.Cell.run`` over
    ``make_test_mesh(n)``; each global batch is phase 22's one-card cut
    times the data axis. See :func:`sharded_cells_rank` for what each rank
    does; here the results are printed rank by rank and checked: local
    argument bytes equal the dry run's on that mesh, the gathered outputs
    within :data:`SHARDED_TOL` and :data:`SHARDED_MAX_REL` of the
    unsharded run on card 0 (bit for bit on one rank, but for the
    moments), the 1-bit path on the gathered gradients bit-identical to
    an eager CPU device. Across ranks, each fault of
    :data:`SHARDED_FAULTS` is planted in a second spawn and must fail
    those checks."""
    import torch
    from repro_torch.distributed.spawn import run_ranks
    on_card = device != "cpu"
    n = torch.cuda.device_count() if on_card else ranks
    if on_card:
        torch.cuda.empty_cache()  # phase 22's cached blocks
        print(f"phase 23: the parent holds "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
              f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved "
              f"on card 0 while {n} ranks run")
    t = time.perf_counter()
    res = run_ranks(sharded_cells_rank, n, device, seed, device=device,
                    timeout_s=900)
    wall = time.perf_counter() - t
    mesh = res[0]["mesh"]
    print(f"sharded cells over {n} {'card' if n == 1 else 'cards'}, mesh "
          f"{tuple(mesh)} (data, model), {LAUNCH_ARCH} "
          f"{'full width' if on_card else 'smoke'}: {wall:.1f} s with the "
          f"ranks' start")
    out = {"ranks": n, "mesh": list(mesh), "wall_s": wall, "cells": {}}
    faults = []  # printed first, every cell, then failed on together
    for name, *_ in LAUNCH_CUTS:
        c0 = res[0]["cells"][name]
        errs = c0["errors"]
        print(f"  {name} at {c0['batch']} x {c0['seq']}: against the "
              f"unsharded cell on card 0 (plain call {c0['plain_s']:.3f} "
              f"s): " + "; ".join(_error_text(k, e)
                                  for k, e in errs.items()))
        for r, rr in enumerate(res):
            c = rr["cells"][name]
            if c["local_arg_bytes"] != c["dry_arg_bytes"]:
                faults.append(f"{name} rank {r}: {c['local_arg_bytes']} "
                              f"local argument bytes, the dry run says "
                              f"{c['dry_arg_bytes']}")
            print(f"    rank {r}: {c['local_arg_bytes']:,} local argument "
                  f"bytes (dry run {c['dry_arg_bytes']:,}); cold "
                  f"{c['cold_s']:.3f} s (collective census on), warm "
                  f"{c['warm_s']:.3f} s; peak {c['peak_gib']:.2f} GiB; "
                  f"census: " + (", ".join(
                      f"{k} {v}" for k, v in c["comm_counts"].items())
                      or "no collective") + "; bytes " + (", ".join(
                      f"{k} {v:,}" for k, v in c["comm_bytes"].items())
                      or "0"))
        if "profile" in c0:
            prof = c0["profile"]
            print(f"    rank 0, one warm step under torch.profiler: "
                  f"{prof['wall_ms']:.1f} ms unprofiled "
                  f"({prof['profiled_wall_ms']:.1f} profiled), device "
                  f"busy {prof['device_ms']:.1f} ms, idle share "
                  f"{prof['idle_share']:.3f}, {prof['device_ops']:.0f} "
                  f"device ops; by kind (ms): " + ", ".join(
                      f"{k} {v:.1f}" for k, v in prof["kinds"].items())
                  + "; longest (name, count, ms): " + "; ".join(
                      f"{k} {n:.0f} {ms:.1f}"
                      for k, n, ms in prof["top_time"]))
        faults += [f"{name} {m}" for m in _sharded_faults(errs, n)]
        out["cells"][name] = {
            "batch": c0["batch"], "errors": errs,
            "profile": c0.get("profile"),
            "ranks": [{k: rr["cells"][name][k] for k in (
                "warm_s", "cold_s", "peak_gib", "local_arg_bytes",
                "comm_counts", "comm_bytes")} for rr in res]}
    ob = res[0]["one_bit"]
    print(f"  1-bit path on the gathered train_4k gradients on rank 0 "
          f"({ob['leaves']} leaves, {ob['words']} wire words): wire "
          f"bitmaps {'equal' if ob['wires_equal'] else 'DIFFER'}, deq and "
          f"err {'equal' if ob['deq_err_equal'] else 'DIFFER'}, EngineStats"
          f" {'equal' if ob['stats_equal'] else 'DIFFER'} against an eager "
          f"CPU device; wall {ob['card_s']:.2f} s card / {ob['cpu_s']:.2f} "
          f"s CPU; K1/K2 launches {ob['launches']}")
    if not (ob["wires_equal"] and ob["deq_err_equal"] and ob["stats_equal"]):
        faults.append("1-bit path on the sharded gradients: the card and "
                      "the CPU differ")
    if on_card and not all(ob["launches"].get(k, 0) > 0 for k in K12):
        faults.append(f"1-bit path: launches {ob['launches']}")
    out["controls"] = {}
    for fault, cells in SHARDED_FAULTS.items() if n > 1 else ():
        t = time.perf_counter()
        ctl = run_ranks(sharded_cells_rank, n, device, seed, fault, cells,
                        device=device, timeout_s=900)[0]
        print(f"  control, fault '{fault}' planted "
              f"({time.perf_counter() - t:.1f} s):")
        for name in cells:
            errs = ctl["cells"][name]["errors"]
            caught = _sharded_faults(errs, n)
            print(f"    {name}: " + "; ".join(_error_text(k, e)
                                             for k, e in errs.items())
                  + f" -> {'caught' if caught else 'NOT CAUGHT'}")
            if not caught:
                faults.append(f"{name}: the checks pass with the fault "
                              f"'{fault}' planted")
            out["controls"][f"{fault}/{name}"] = errs
    check(not faults, "phase 23: " + "; ".join(faults))
    out["one_bit"] = ob
    out["launches"] = ob["launches"]
    return out


def _error_text(key: str, e: dict) -> str:
    """One output's reading against the unsharded run."""
    if e["equal"]:
        return f"{key} bit-identical"
    text = (f"{key} max abs err {e['max_abs']:.3g} (max rel "
            f"{e['max_rel']:.3g}")
    if e["leaves"] > 1:
        text += f" at {e['where']}, norm rel {e['norm_rel']:.3g}"
    if key in SHARDED_TOL:
        text += f", {e['worst']:.3g} x its tolerance"
    return text + ")"


def _sharded_faults(errs: dict, n: int) -> list[str]:
    """The readings of one cell that fail phase 23's checks: on one rank
    every output but the moments bit-identical; otherwise within
    :data:`SHARDED_MAX_REL` where it has a limit, else within
    :data:`SHARDED_TOL`."""
    out = []
    for key, e in errs.items():
        if n == 1 and not e["equal"] and key not in ("mu", "nu",
                                                     "grad_norm"):
            out.append(f"{key}: the (1, 1) run differs from the unsharded "
                       f"one (max abs err {e['max_abs']:.3g})")
        elif key in SHARDED_MAX_REL:
            if e["max_rel"] > SHARDED_MAX_REL[key]:
                out.append(f"{key}: max abs err {e['max_abs']:.3g} is "
                           f"{e['max_rel']:.3g} of the largest value, above "
                           f"{SHARDED_MAX_REL[key]}")
        elif e["worst"] > 1.0:
            rtol, atol = SHARDED_TOL[key]
            out.append(f"{key}: {e['worst']:.3g} x the tolerance (rtol "
                       f"{rtol}, atol {atol}; max abs err "
                       f"{e['max_abs']:.3g})")
    return out


def _view(kind: str, res, seq: int) -> dict:
    """The outputs a sharded run is held to: the train loss, gradient
    norm, updated parameters and AdamW moments; the serving logits and
    caches (decode: the ring slot the step wrote, at position
    ``seq - 1``)."""
    from repro_torch.models.tree import tree_leaves
    if kind == "train":
        return {"loss": res[2]["loss"], "grad_norm": res[2]["grad_norm"],
                "params": res[0], "mu": res[1]["mu"], "nu": res[1]["nu"]}
    if kind == "prefill":
        return {"logits": res[0], "caches": res[1]}
    slot = seq - 1  # every row's position (lm_cell_args), ring size seq
    return {"logits": res[0],
            "caches": [c[:, :, slot] for c in tree_leaves(res[1])]}


def _errors(got: dict, want: dict) -> dict:
    """Per output: bit equality; the max abs error; the largest over its
    leaves of ``max |a - b| / max |b|`` (``max_rel``, at the leaf
    ``where``) and of ``||a - b|| / ||b||`` (``norm_rel``); and, where
    :data:`SHARDED_TOL` has its tolerance, the largest ``|a - b| / (atol
    + rtol |b|)``."""
    import torch
    from repro_torch.models.tree import tree_items
    out = {}
    for key in got:
        rtol, atol = SHARDED_TOL.get(key, (0.0, 0.0))
        e = {"equal": True, "max_abs": 0.0, "max_rel": 0.0, "where": "",
             "norm_rel": 0.0, "worst": 0.0, "leaves": 0}
        for (path, g), (_, w) in zip(tree_items(got[key]),
                                     tree_items(want[key])):
            g, w = g.detach(), w.detach().to(g.device)
            e["leaves"] += 1
            e["equal"] = e["equal"] and torch.equal(g, w)
            d = (g.float() - w.float()).abs()
            wf = w.float()
            rel = float(d.max()) / max(float(wf.abs().max()), 1e-30)
            e["max_abs"] = max(e["max_abs"], float(d.max()))
            if rel > e["max_rel"] or not e["where"]:
                e["max_rel"], e["where"] = max(rel, e["max_rel"]), path
            e["norm_rel"] = max(e["norm_rel"], float(
                d.norm() / max(float(wf.norm()), 1e-30)))
            if key in SHARDED_TOL:
                e["worst"] = max(e["worst"], float(
                    (d / (atol + rtol * wf.abs())).max()))
        out[key] = e
    return out


def _plant(fault: str) -> None:
    """Install the fault ``fault`` in this rank. Each keeps this rank's
    own partial sums where the program sums them over ranks (no
    all-reduce or reduce-scatter): ``grad_sums_kept`` in the gradients'
    ``layout_like`` (the embedding's and final norm's gradients lose their
    sum over the data shards; the forward is untouched),
    ``partial_sums_kept`` in every explicit ``DTensor.redistribute`` (the
    model's ``token_einsum`` sums, forward)."""
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.train import trainer

    def kept(x):
        if not any(pl.is_partial() for pl in x.placements):
            return x
        return DTensor.from_local(
            x.to_local(), x.device_mesh,
            [Replicate() if pl.is_partial() else pl for pl in x.placements],
            shape=x.shape, stride=x.stride())

    if fault == "grad_sums_kept":
        real_layout = trainer.layout_like
        trainer.layout_like = lambda x, ref: real_layout(
            kept(x) if isinstance(x, DTensor) else x, ref)
    elif fault == "partial_sums_kept":
        real = DTensor.redistribute
        DTensor.redistribute = (lambda self, *a, **kw:
                                real(kept(self), *a, **kw))
    else:
        raise ValueError(f"no fault {fault!r}")


def sharded_cells_rank(rank: int, world: int, device: str, seed: int,
                       fault: str | None = None,
                       cells: tuple | None = None) -> dict:
    """One rank of phase 23. For each cell: its arguments placed by its
    ``in_shardings`` (state and cache leaves made as this rank's shard
    only), their local bytes beside ``dryrun.argument_bytes`` on the
    mesh; on rank 0 first the unsharded ``cell.fn`` on the same weights
    and inputs; a cold ``Cell.run`` under ``CommDebugMode`` and the dry
    run's byte census, its outputs gathered and held (rank 0) against the
    unsharded ones; for ``train_4k`` the step's gradients
    (``trainer.loss_and_grads`` on the placed state, gathered to rank 0);
    then a warm run (wall ending in a read-back, peak memory) and, across
    ranks, ``train_4k`` twice more, the second under ``torch.profiler``
    (:func:`profile_ticks`). Last, on rank
    0, the 1-bit sign path on those gradients through K1/K2 against an
    eager CPU device. With ``fault`` (see :func:`_plant`) only
    ``cells`` run, through their comparison."""
    import torch
    import torch.distributed.tensor as dtensor
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.config.base import (LM_SHAPES, ShapeConfig, TrainConfig,
                                         get_config, get_smoke_config)
    from repro_torch.distributed.constraints import use_mesh
    from repro_torch.distributed.sharding import (distribute_tree,
                                                  gather_tree, placements,
                                                  shard_box)
    from repro_torch.kernels import _build
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.mesh import device_mesh, make_test_mesh
    from repro_torch.models.tree import tree_leaves, tree_map
    from repro_torch.train import trainer
    on_card = device != "cpu"
    dev = torch.device("cuda", rank) if on_card else torch.device("cpu")
    cfg = get_config(LAUNCH_ARCH) if on_card \
        else get_smoke_config(LAUNCH_ARCH)
    if on_card and world == 1:
        cfg = dataclasses.replace(cfg, n_layers=SHARDED_ONE_CARD_LAYERS)
    if not on_card or world == 1:
        # the rehearsal's smoke config, one card's cut: through build_cell
        steps.get_config = lambda arch: cfg
    mesh = make_test_mesh(world) if on_card \
        else make_test_mesh(devices=["cpu"] * world)
    dm = device_mesh(mesh)
    if fault is not None:
        _plant(fault)

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def place(x, sharding):  # this rank's part of a full leaf
        part = dtensor.zeros(
            tuple(x.shape), dtype=x.dtype, device_mesh=dm,
            placements=placements(sharding.spec, sharding.mesh.axis_names,
                                  sharding.mesh.axis_sizes))
        part.to_local().copy_(x[tuple(slice(s, s + k)
                                      for s, k in shard_box(part))])
        return part

    def read_back(kind, res):
        x = res[2]["loss"] if kind == "train" else res[0]
        return getattr(x, "to_local", lambda: x)().float().cpu()

    out = {"mesh": mesh.axis_sizes, "cells": {}}
    grads = None
    for name, cut, _ in LAUNCH_CUTS:
        if cells is not None and name not in cells:
            continue
        g = LM_SHAPES[name]
        seq = g.seq_len if on_card else 16
        shape = ShapeConfig(name, g.kind, seq, cut * mesh.shape["data"])
        cell = steps.build_cell(LAUNCH_ARCH, shape, mesh)
        r = {"batch": shape.global_batch, "seq": seq,
             "dry_arg_bytes": dryrun.argument_bytes(cell, mesh)}
        want = None
        if rank == 0:
            plain = lm_cell_args(cell, cfg, dev, seed)
            sync()
            t = time.perf_counter()
            res = cell.fn(*plain)
            sync()
            r["plain_s"] = time.perf_counter() - t
            want = tree_map(lambda x: x.detach().clone(),
                            _view(g.kind, res, seq))
            del plain, res
            if on_card:
                torch.cuda.empty_cache()
        placed = distribute_tree(
            lm_cell_args(cell, cfg, dev, seed, place=place),
            cell.in_shardings, dm)
        r["local_arg_bytes"] = sum(x.to_local().numel()
                                   * x.to_local().element_size()
                                   for x in tree_leaves(placed))
        sync()
        t = time.perf_counter()
        with CommDebugMode() as comm, dryrun.collective_bytes() as nbytes:
            res = cell.run(placed, dm)
            read_back(g.kind, res)
        r["cold_s"] = time.perf_counter() - t
        r["comm_counts"] = {str(k).rsplit(".", 1)[-1]: v
                            for k, v in comm.get_comm_counts().items()}
        r["comm_bytes"] = dict(nbytes.bytes)
        got = gather_tree(_view(g.kind, res, seq))
        if rank == 0:
            r["errors"] = _errors(got, want)
        del got, want, res
        if fault is not None:
            out["cells"][name] = r
            continue
        if g.kind == "train":
            with use_mesh(dm), implicit_replication():
                grads = trainer.loss_and_grads(cfg, TrainConfig(), placed[0],
                                               placed[2])[2]
            full = gather_tree(grads)  # every rank takes part
            grads = full if rank == 0 else None
            del full
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        sync()
        t = time.perf_counter()
        res = cell.run(placed, dm)
        read_back(g.kind, res)
        r["warm_s"] = time.perf_counter() - t
        r["peak_gib"] = (torch.cuda.max_memory_allocated(dev) / 2**30
                         if on_card else 0.0)
        del res
        if on_card and world > 1 and g.kind == "train":
            r["profile"] = profile_ticks(
                lambda: read_back(g.kind, cell.run(placed, dm)), 1)
        del placed, cell
        if on_card:
            torch.cuda.empty_cache()
        out["cells"][name] = r
    if grads is not None:  # rank 0, after train_4k
        out["one_bit"] = one_bit_run(grads, dev, _build)
    return out


def one_bit_run(grads, dev, build) -> dict:
    """``compress_grads_sign_with_feedback`` on ``grads`` (zero error) on
    a fused ``pum.device(width=32)`` on ``dev`` and on an eager CPU
    device: wire bitmaps, ``deq``, ``err`` and ``EngineStats`` compared,
    the K1/K2 launches of the card's run counted."""
    import numpy as np
    import torch
    import repro_torch.pum as pum
    from repro_torch.models.tree import tree_leaves, tree_map
    from repro_torch.train import grad_compress as gc
    err = tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                         device=x.device), grads)
    wires = {"card": [], "cpu": []}
    real_wire = gc.pum_wire_bitmap

    def run(label, pdev, g, e):
        def spy(s, m, d=None):
            w = real_wire(s, m, d)
            wires[label].append(w)
            return w
        gc.pum_wire_bitmap = spy
        try:
            t = time.perf_counter()
            res = gc.compress_grads_sign_with_feedback(g, e, device=pdev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            return res, time.perf_counter() - t
        finally:
            gc.pum_wire_bitmap = real_wire

    card_dev = pum.device(width=32, fuse=True, device=dev)
    host_dev = pum.device(width=32, fuse=False, device="cpu")
    reset_launches(build)
    (cq, ce), card_s = run("card", card_dev, grads, err)
    launches = {k: build.LAUNCHES.get(k, 0) for k in K12}
    (hq, he), cpu_s = run("cpu", host_dev,
                          tree_map(lambda x: x.cpu(), grads),
                          tree_map(lambda x: x.cpu(), err))
    return {"leaves": len(tree_leaves(grads)),
            "words": sum(len(w) for w in wires["card"]),
            "wires_equal": len(wires["card"]) == len(wires["cpu"]) > 0
            and all(np.array_equal(a, b)
                    for a, b in zip(wires["card"], wires["cpu"])),
            "deq_err_equal": tree_equal(cq, hq) and tree_equal(ce, he),
            "stats_equal": card_dev.stats.as_dict()
            == host_dev.stats.as_dict(),
            "card_s": card_s, "cpu_s": cpu_s, "launches": launches}


SUBQ_ARCHS = ("mamba2-130m", "hymba-1.5b")   # the sub-quadratic family
# (shape, batch on one card[, layers]) per arch: each shape's sequence
# length is kept; the global batch is cut to what one 80 GB card holds,
# and batch or depth further to keep the script inside its time limit
# (PERF.md section 4): hymba-1.5b's prefill_32k would fit 4 sequences (2
# peak at ~30 GiB) but a call of 2 takes ~36 s, so it runs 1 at its 32
# layers (the configuration a device-side index assert was once seen
# in); mamba2-130m's train_4k runs 2 sequences (16 peak at 67 GiB) and
# its prefill_32k 4 (16 peak at 67 GiB, 5.4 s a call at 8),
# hymba-1.5b's train_4k 1 sequence at 16 of its 32 layers (4 peak at 58
# GiB, 2 take 3.2 s a call at 32 layers).
SUBQ_CUTS = {
    "mamba2-130m": (("train_4k", 2), ("prefill_32k", 4),
                    ("decode_32k", 128), ("long_500k", 1)),
    "hymba-1.5b": (("train_4k", 1, 16), ("prefill_32k", 1),
                   ("decode_32k", 128), ("long_500k", 1)),
}
SSM_STATE_TOKENS = 2048   # a prefill of several 256-token chunks
SSM_STATE_TOL = 1e-4      # of the state's largest magnitude, float32


def ssm_state_tap(ssm_mod, errs: list):
    """``ssm.final_state`` (the prefill's closed form) that also runs the
    per-token recurrence ``final_state_naive`` on the same inputs and
    appends the largest difference, as a share of the recurrence's
    largest magnitude, to ``errs``."""
    closed = ssm_mod.final_state

    def tapped(x, dt, a_log, b, state):
        got = closed(x, dt, a_log, b, state)
        want = ssm_mod.final_state_naive(x, dt, a_log, b, state)
        errs.append(float((got - want).abs().max() / want.abs().max()))
        return got
    return tapped


def lm_subquadratic(device: str, build, seed: int) -> dict:
    """Phase 24 (``lm_subquadratic``) on ``device`` (``"cuda"`` on the
    card; on the CPU it rehearses at each arch's smoke config): for
    mamba2-130m and hymba-1.5b, :func:`subquadratic_arch`; then the
    ``serve_llm`` example for mamba2-130m, as a user runs it."""
    import contextlib
    import io
    import torch
    from repro_torch.examples import serve_llm
    if device != "cpu":
        _free(True)  # earlier phases' closed engines hold tensors in cycles
        print(f"phase 24 starts with "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    out = {arch: subquadratic_arch(arch, device, build, seed)
           for arch in SUBQ_ARCHS}
    argv = ["--arch", "mamba2-130m", "--device", device]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        done = serve_llm.main(argv)
    lines = buf.getvalue().splitlines()
    check(len(done) == 6 and all(len(r.out_tokens) == 12 for r in done)
          and lines[0].startswith("6 requests, 72 tokens in "),
          f"serve_llm printed {lines}")
    print(f"example (python -m repro_torch.examples.serve_llm "
          f"{' '.join(argv)}): " + " | ".join(lines[:2]))
    out["launches"] = {k: sum(out[a]["serve_launches"][k]
                              for a in SUBQ_ARCHS) for k in K12}
    return out


def subquadratic_arch(arch: str, device: str, build, seed: int) -> dict:
    """Phase 24 for one arch (its full config on the card):

    a. bfloat16 through ``ServeEngine`` three ways
       (:func:`serve_three_ways`: equal streams, K1/K2 each tick, the
       profile), the parameter count equal to ``count_params``;
    b. float32, the card against the CPU: prefill 2 x 16 tokens and 4
       decode steps within ``SERVE_F32_TOL`` with equal greedy tokens;
       then a prefill of 2 x ``SSM_STATE_TOKENS`` tokens and 4 decode
       steps on the card, every layer's SSM state held against the
       per-token recurrence within ``SSM_STATE_TOL``;
    c. ``train_4k``, ``prefill_32k``, ``decode_32k`` and ``long_500k``
       cut to :data:`SUBQ_CUTS` (:func:`run_cells`);
    d. the launcher, ``python -m repro_torch.launch.serve --arch ARCH``,
       in process."""
    import numpy as np
    import torch
    from repro_torch.config.base import get_config, get_smoke_config
    from repro_torch.models import model as lm
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models.tree import tree_leaves, tree_map
    on_card = device != "cpu"
    dev = torch.device(device)
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are enabled: float32 checks would see TF32 error")
    cfg = get_config(arch) if on_card else get_smoke_config(arch)
    stamp = _stamper(f"24 {arch}")

    # -- a. bf16 through ServeEngine, three ways ------------------------ #
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    n_params = sum(x.numel() for x in tree_leaves(params))
    check(n_params == cfg.param_count(),
          f"{arch}: {n_params} parameters, count_params says "
          f"{cfg.param_count()}")
    print(f"{arch} ({cfg.name}): {cfg.n_layers} layers, d {cfg.d_model}, "
          f"SSM heads {ssm_mod.ssm_dims(cfg)[1]} x {cfg.ssm_head_dim}, "
          f"state {cfg.ssm_state}, padded vocab {cfg.padded_vocab}, "
          f"{n_params} parameters = count_params; compute {cfg.dtype}")
    out = serve_three_ways(cfg, params, build, dev, f"{arch} serve")
    stamp("a")

    # -- b. float32: the card against the CPU; the prefill state -------- #
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    t = time.perf_counter()
    cpu_params = tree_map(lambda x: x.cpu(), params)
    batch = lm_inputs(cfg32, np.random.default_rng(seed), 2, 16, dev)
    errs, same = lm_parity(cfg32, params, cpu_params, batch, dev, steps=4,
                           forward=False)
    del cpu_params
    err = max(errs.values())
    print(f"{arch} float32, {device} against CPU (prefill 2 x 16 tokens, "
          f"4 decode steps): max abs logit error {err:.3e} (bound "
          f"{SERVE_F32_TOL:g}), greedy tokens "
          f"{'equal' if same else 'DIFFER'}, {time.perf_counter() - t:.1f} s")
    check(err <= SERVE_F32_TOL and same,
          f"{arch} float32 against the CPU: {errs}, tokens equal {same}")
    n_tok = SSM_STATE_TOKENS if on_card else 40
    batch = lm_inputs(cfg32, np.random.default_rng(seed + 2), 2, n_tok, dev)
    state_errs = []
    closed = ssm_mod.final_state
    ssm_mod.final_state = ssm_state_tap(ssm_mod, state_errs)
    t = time.perf_counter()
    try:
        with torch.no_grad():
            logits, caches, _ = lm.prefill(cfg32, params, batch, n_tok + 4)
    finally:
        ssm_mod.final_state = closed
    tap_s = time.perf_counter() - t
    with torch.no_grad():
        finite = [bool(torch.isfinite(logits).all())]
        for i in range(4):
            tok = logits[:, :cfg.vocab_size].argmax(-1)
            pos = torch.full((2,), n_tok + i, dtype=torch.long, device=dev)
            logits, caches = lm.decode_step(cfg32, params, caches, tok, pos)
            finite.append(bool(torch.isfinite(logits).all()))
    worst = max(state_errs)
    print(f"{arch} float32 prefill of 2 x {n_tok} tokens on {device} "
          f"(chunk {cfg.ssm_chunk}): the SSM state of each of "
          f"{len(state_errs)} layers against the per-token recurrence, "
          f"largest difference {worst:.3e} of the state's largest "
          f"magnitude (bound {SSM_STATE_TOL:g}); 4 decode steps, logits "
          f"finite {all(finite)}; {tap_s:.1f} s with the recurrence")
    check(len(state_errs) == cfg.n_layers and worst <= SSM_STATE_TOL
          and all(finite), f"{arch} prefill state: {state_errs}, finite "
          f"{finite}")
    out.update(f32_err=err, state_err=worst)
    del params, batch, logits, caches
    _free(on_card)
    stamp("b")

    # -- c. the four cells on one card ---------------------------------- #
    out["cells"] = run_cells(arch, SUBQ_CUTS[arch], device, seed)
    stamp("c")

    # -- d. the launcher, as a user runs it ----------------------------- #
    serve_launcher(arch, device)
    stamp("d")
    return out


MOE_ARCH = "moonshot-v1-16b-a3b"         # the MoE family
ENCDEC_ARCH = "seamless-m4t-large-v2"    # the encoder-decoder family
MOE_F32_LAYERS = 4   # the dense layer and 3 MoE layers: 9.1 GiB in float32
ENCDEC_FRAMES = 48   # float32 check: a memory longer than the 16 tokens
# (shape, batch on one card, layers; None keeps the depth): each shape's
# sequence length and the width are kept. moonshot-v1-16b-a3b's decode_32k
# runs its 48 layers (52.7 GiB of bfloat16 weights, 12.0 GiB of cache at
# 1 sequence); its train_4k 4 layers (float32 weights, gradients and
# AdamW moments: 36.5 GiB; all 48 would need ~420 GiB); its prefill_32k
# 2 layers (the dense layer and 1 MoE) for time: all 48 would fit at ~70
# GiB but take ~18 s a call (4 layers take 1.5 s).
# seamless-m4t-large-v2's batches are cut to fit 80 GB (PERF.md section
# 4), its train_4k further to 1 for time (4 take 1.8 s a call); its
# train_4k and decode_32k keep their 24 + 24 layers, its prefill_32k runs
# 4 + 4 for time (at 24 + 24, 9.4 s a call; at 8 + 8, 3.1 s).
MOE_ENCDEC_CUTS = {
    MOE_ARCH: (("train_4k", 2, 4), ("prefill_32k", 1, 2),
               ("decode_32k", 1, None)),
    ENCDEC_ARCH: (("train_4k", 1, None), ("prefill_32k", 1, 4),
                  ("decode_32k", 16, None)),
}


def encdec_flops(cfg, name: str, cut: int) -> dict:
    """What the roofline's analytic FLOPs leave out of an encoder-decoder
    cell at ``cut`` sequences: every decoder layer's cross-attention
    (query and output projections, the memory's K/V projection, scores
    and values) and the encoder as it runs (over the frames: half a
    ``train`` sequence, ``n_frontend_tokens`` at prefill, none in a
    decode step) beside the encoder term the roofline counts (over the
    cell's whole sequence, at its mean context); train counts forward,
    backward and remat as the roofline does."""
    from repro_torch.config.base import LM_SHAPES
    g = LM_SHAPES[name]
    d, h, hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    dh = cfg.resolved_head_dim
    mult = (4.0 if cfg.remat == "full" else 3.0) if g.kind == "train" \
        else 1.0
    if g.kind == "train":
        t = f = g.seq_len // 2
    else:
        t, f = (g.seq_len if g.kind == "prefill" else 1), \
            cfg.n_frontend_tokens
    proj = 2 * d * dh * (h + 2 * hkv) + 2 * h * dh * d
    xattn = cfg.n_layers * (t * 4 * d * h * dh + f * 4 * d * hkv * dh
                            + 4 * t * f * h * dh)
    layer = proj + 6 * d * cfg.d_ff
    enc = 0 if g.kind == "decode" else \
        cfg.n_encoder_layers * f * (layer + 4 * f * h * dh)
    counted = 0 if g.kind == "decode" else cfg.n_encoder_layers \
        * g.seq_len * (layer + 4 * (g.seq_len / 2) * h * dh)
    return {"xattn_flops": xattn * cut * mult,
            "encoder_flops": enc * cut * mult,
            "encoder_counted_flops": counted * cut * mult}


def moe_route_tap(moe_mod, cfg, log: list):
    """``moe.top_k`` that also appends, for each call (one MoE layer's
    router), the expert ids it chose and the capacity-drop mask
    ``moe.dispatch`` gives them, both on the host, to ``log``."""
    chosen = moe_mod.top_k

    def tapped(probs, k):
        w, idx = chosen(probs, k)
        _, ok = moe_mod.dispatch(idx.reshape(-1), cfg.n_experts,
                                 moe_mod.capacity(cfg, probs.shape[0]))
        log.append((idx.cpu(), ok.cpu()))
        return w, idx
    return tapped


def route_blocks(routes: list, n_moe: int, stages: int) -> tuple:
    """Read :func:`moe_route_tap`'s log of one :func:`lm_parity` run,
    which runs each stage on the device, then on the CPU (blocks of one
    router call per MoE layer, alternating): whether the device's expert
    ids and drop masks equal the CPU's at all ``stages`` stages, and the
    (token, choice) entries dropped and routed at each device stage."""
    import torch
    blocks = [routes[i:i + n_moe] for i in range(0, len(routes), n_moe)]
    card, host = blocks[0::2], blocks[1::2]
    equal = len(card) == len(host) == stages and all(
        torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        for ca, hb in zip(card, host) for a, b in zip(ca, hb))
    dropped = [sum(int((~ok).sum()) for _, ok in blk) for blk in card]
    entries = [sum(ok.numel() for _, ok in blk) for blk in card]
    return equal, dropped, entries


def lm_moe_encdec(device: str, build, seed: int) -> dict:
    """Phase 25 (``lm_moe_encdec``) on ``device`` (``"cuda"`` on the card;
    on the CPU it rehearses at each arch's smoke config):
    :func:`moe_arch` for moonshot-v1-16b-a3b, then :func:`encdec_arch`
    for seamless-m4t-large-v2."""
    import torch
    if device != "cpu":
        _free(True)  # earlier phases' closed engines hold tensors in cycles
        print(f"phase 25 starts with "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    out = {MOE_ARCH: moe_arch(device, build, seed)}
    out[ENCDEC_ARCH] = encdec_arch(device, seed)
    out["launches"] = out[MOE_ARCH]["serve_launches"]
    return out


def moe_arch(device: str, build, seed: int) -> dict:
    """Phase 25 for moonshot-v1-16b-a3b (its full config on the card):

    a. bfloat16 at full depth, the weights drawn in bfloat16 a layer
       slice at a time (``init_params(..., dtype=torch.bfloat16)``),
       their count equal to ``count_params``, through ``ServeEngine``
       three ways (:func:`serve_three_ways`: equal streams, K1/K2 each
       tick, the profile);
    b. float32 at :data:`MOE_F32_LAYERS` layers, the card against the
       CPU (:func:`lm_parity`: prefill 2 x 16 tokens and 4 decode steps
       within ``SERVE_F32_TOL``, greedy tokens equal), every MoE layer's
       expert ids and capacity-drop mask identical on both at the prefill
       and at each decode step (:func:`moe_route_tap`);
    c. its cells cut to :data:`MOE_ENCDEC_CUTS` (:func:`run_cells`).

    No launcher run: ``launch/serve.py`` builds ``ServeEngine(cfg)``,
    which draws the 105.5 GiB of float32 masters, as the reference's
    launcher does."""
    import numpy as np
    import torch
    from repro_torch.config.base import get_config, get_smoke_config
    from repro_torch.models import model as lm
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.tree import tree_leaves, tree_map
    arch = MOE_ARCH
    on_card = device != "cpu"
    dev = torch.device(device)
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are enabled: float32 checks would see TF32 error")
    cfg = get_config(arch) if on_card else get_smoke_config(arch)
    stamp = _stamper(f"25 {arch}")

    # -- a. bf16 at full depth through ServeEngine, three ways ---------- #
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev, dtype=torch.bfloat16)
    n_params = sum(x.numel() for x in tree_leaves(params))
    check(n_params == cfg.param_count() and all(
        x.dtype == torch.bfloat16 for x in tree_leaves(params)),
          f"{arch}: {n_params} parameters, count_params says "
          f"{cfg.param_count()}")
    print(f"{arch} ({cfg.name}): {cfg.n_layers} layers "
          f"({cfg.first_dense_layers} dense), d {cfg.d_model}, "
          f"{cfg.n_heads} heads of "
          f"{cfg.resolved_head_dim}, {cfg.n_experts} experts top-"
          f"{cfg.top_k} + {cfg.n_shared_experts} shared of "
          f"{cfg.moe_d_ff}, padded vocab {cfg.padded_vocab}, {n_params:,} "
          f"parameters drawn in bfloat16 = count_params; "
          + (f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB "
             f"allocated" if on_card else "on the CPU"))
    out = serve_three_ways(cfg, params, build, dev, f"{arch} serve")
    del params
    _free(on_card)
    stamp("a")

    # -- b. float32 at a cut depth: the card against the CPU ------------ #
    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                n_layers=min(MOE_F32_LAYERS, cfg.n_layers))
    t = time.perf_counter()
    params = lm.init_params(cfg32, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    cpu_params = tree_map(lambda x: x.cpu(), params)
    batch = lm_inputs(cfg32, np.random.default_rng(seed), 2, 16, dev)
    routes: list = []
    chosen = moe_mod.top_k
    moe_mod.top_k = moe_route_tap(moe_mod, cfg32, routes)
    try:
        errs, same = lm_parity(cfg32, params, cpu_params, batch, dev,
                               steps=4, forward=False)
    finally:
        moe_mod.top_k = chosen
    del params, cpu_params
    err = max(errs.values())
    n_moe = cfg32.n_layers - cfg32.first_dense_layers
    routes_equal, dropped, entries = route_blocks(routes, n_moe, 5)
    print(f"{arch} float32 at {cfg32.n_layers} layers, {device} against "
          f"CPU (prefill 2 x 16 tokens, 4 decode steps): max abs logit "
          f"error {err:.3e} (bound {SERVE_F32_TOL:g}), greedy tokens "
          f"{'equal' if same else 'DIFFER'}; router decisions of {n_moe} "
          f"MoE layers at the prefill and 4 decode steps (capacity "
          f"{moe_mod.capacity(cfg32, 32)} and "
          f"{moe_mod.capacity(cfg32, 2)} a expert): expert ids and drop "
          f"masks {'identical' if routes_equal else 'DIFFER'}, dropped "
          f"{dropped} of {entries} (token, choice) entries; "
          f"{time.perf_counter() - t:.1f} s")
    check(err <= SERVE_F32_TOL and same and routes_equal,
          f"{arch} float32 against the CPU: {errs}, tokens equal {same}, "
          f"routes equal {routes_equal} ({len(routes)} router calls)")
    out.update(f32_err=err, dropped=dropped)
    _free(on_card)
    stamp("b")

    # -- c. the cells on one card ------------------------------------------ #
    out["cells"] = run_cells(arch, MOE_ENCDEC_CUTS[arch], device, seed)
    stamp("c")
    return out


def prefix_serve(cfg, params, dev, seed: int, tag: str) -> dict:
    """Greedy serving of a model with a frontend prefix through
    ``prefill`` and ``decode_step`` (``ServeEngine`` passes no frames or
    patches, in the reference as in the port): 4 sequences of
    ``n_frontend_tokens`` audio frames (the encoder's memory) or image
    patches (ahead of the prompt), normal with scale 0.02, and 16-token
    prompts from ``default_rng(seed)``, 16 greedy decode steps after the
    prefill's token, run twice; the two token streams are identical. On
    the card, 8 decode steps at the last position are profiled."""
    import numpy as np
    import torch
    from repro_torch.models import model as lm
    on_card = dev.type == "cuda"
    b, t, steps = 4, 16, 16
    batch = lm_inputs(cfg, np.random.default_rng(seed), b, t, dev,
                      prefix=cfg.n_frontend_tokens)
    kind = "frames" if cfg.encoder_decoder else "patches"
    # a patch prefix takes positions ahead of the prompt
    t0_pos = t + (cfg.n_frontend_tokens if kind == "patches" else 0)

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def run():
        sync()
        t0 = time.perf_counter()
        with torch.no_grad():
            logits, caches, memory = lm.prefill(cfg, params, batch,
                                                t0_pos + steps)
            tok = logits[:, :cfg.vocab_size].argmax(-1)
            toks = [tok.cpu()]
            t1 = time.perf_counter()
            for i in range(steps):
                pos = torch.full((b,), t0_pos + i, dtype=torch.long,
                                 device=dev)
                logits, caches = lm.decode_step(cfg, params, caches, tok,
                                                pos, memory=memory)
                tok = logits[:, :cfg.vocab_size].argmax(-1)
                toks.append(tok.cpu())   # a read-back each step
        t2 = time.perf_counter()
        return (torch.stack(toks, 1), t1 - t0, (t2 - t1) / steps,
                t2 - t0, (caches, memory, tok))

    runs = [run() for _ in range(2)]
    same = torch.equal(runs[0][0], runs[1][0])
    streams, prefill_s, step_s, wall, (caches, memory, tok) = runs[1]
    out = {"prefill_s": prefill_s, "decode_step_ms": step_s * 1e3,
           "tok_s": b * (steps + 1) / wall, "streams_equal": same}
    print(f"{tag}: {b} sequences x {cfg.n_frontend_tokens} {kind} + "
          f"{t}-token prompts, the prefill's token and {steps} greedy "
          f"decode steps each, run twice: "
          f"token streams {'identical' if same else 'DIFFER'}; warm run "
          f"prefill {prefill_s * 1e3:.1f} ms, decode "
          f"{step_s * 1e3:.3f} ms a step, {out['tok_s']:.1f} tok/s "
          f"({wall:.3f} s)")
    check(same and streams.shape == (b, steps + 1),
          f"{tag}: the two runs gave different tokens")
    if on_card:
        pos = torch.full((b,), t0_pos + steps - 1, dtype=torch.long,
                         device=dev)

        def step():
            with torch.no_grad():
                return lm.decode_step(cfg, params, caches, tok, pos,
                                      memory=memory)
        prof = profile_ticks(step, 8)
        check(prof is not None, f"{tag}: the profiler saw no device events")
        print(f"{tag} decode step under torch.profiler (8 steps): "
              f"{prof['wall_ms']:.3f} ms a step unprofiled "
              f"({prof['profiled_wall_ms']:.3f} profiled), device busy "
              f"{prof['device_ms']:.3f} ms, idle share "
              f"{prof['idle_share']:.3f}, {prof['device_ops']:.1f} device "
              f"ops a step; longest (name, per step, ms): " + "; ".join(
                  f"{k} {n:.1f} {ms:.3f}" for k, n, ms in prof["top_time"]))
        out["profile"] = prof
    return out


def encdec_arch(device: str, seed: int) -> dict:
    """Phase 25 for seamless-m4t-large-v2 (its full config on the card):

    a. bfloat16 at full depth, the weights drawn in bfloat16, through
       ``prefill``/``decode_step`` with the encoder's memory
       (:func:`prefix_serve`);
    b. float32 at full depth, the card against the CPU (:func:`lm_parity`:
       prefill 2 x 16 tokens over :data:`ENCDEC_FRAMES` frames, 4 decode
       steps carrying the memory, within ``SERVE_F32_TOL``, greedy tokens
       equal);
    c. its cells cut to :data:`MOE_ENCDEC_CUTS` (:func:`run_cells`).

    No launcher run: ``launch/serve.py`` serves through ``ServeEngine``,
    which gives ``prefill`` no frames (``KeyError: 'frames'``), as the
    reference's does."""
    import numpy as np
    import torch
    from repro_torch.config.base import get_config, get_smoke_config
    from repro_torch.models import model as lm
    from repro_torch.models.tree import tree_leaves, tree_map
    arch = ENCDEC_ARCH
    on_card = device != "cpu"
    dev = torch.device(device)
    cfg = get_config(arch) if on_card else get_smoke_config(arch)
    stamp = _stamper(f"25 {arch}")

    # -- a. bf16 serving through prefill/decode_step -------------------- #
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev, dtype=torch.bfloat16)
    n_params = sum(x.numel() for x in tree_leaves(params))
    check(n_params == cfg.param_count(),
          f"{arch}: {n_params} parameters, count_params says "
          f"{cfg.param_count()}")
    print(f"{arch} ({cfg.name}): {cfg.n_encoder_layers} encoder + "
          f"{cfg.n_layers} decoder layers, d {cfg.d_model}, {cfg.n_heads} "
          f"heads of {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, padded vocab "
          f"{cfg.padded_vocab}, {n_params:,} parameters drawn in bfloat16 "
          f"= count_params")
    out = prefix_serve(cfg, params, dev, seed, f"{arch} serve")
    del params
    _free(on_card)
    stamp("a")

    # -- b. float32 at full depth: the card against the CPU ------------- #
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    t = time.perf_counter()
    params = lm.init_params(cfg32, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    cpu_params = tree_map(lambda x: x.cpu(), params)
    batch = lm_inputs(cfg32, np.random.default_rng(seed), 2, 16, dev,
                      prefix=ENCDEC_FRAMES)
    errs, same = lm_parity(cfg32, params, cpu_params, batch, dev, steps=4,
                           forward=False)
    del params, cpu_params
    err = max(errs.values())
    print(f"{arch} float32, {device} against CPU (prefill 2 x 16 tokens "
          f"over {ENCDEC_FRAMES} frames, 4 decode steps with the memory): "
          f"max abs logit error {err:.3e} (bound {SERVE_F32_TOL:g}), "
          f"greedy tokens {'equal' if same else 'DIFFER'}, "
          f"{time.perf_counter() - t:.1f} s")
    check(err <= SERVE_F32_TOL and same,
          f"{arch} float32 against the CPU: {errs}, tokens equal {same}")
    out["f32_err"] = err
    _free(on_card)
    stamp("b")

    # -- c. the cells on one card ---------------------------------------- #
    out["cells"] = run_cells(arch, MOE_ENCDEC_CUTS[arch], device, seed)
    stamp("c")
    return out


VLM_ARCH = "llava-next-mistral-7b"   # the vision-language family
MLA_ARCH = "deepseek-v2-236b"        # the MLA + MoE family
VLM_F32_LAYERS = 4     # float32 check: 4 of 32 layers, 4.25 GiB
VLM_F32_PATCHES = 64   # float32 check: a patch prefix the CPU runs in seconds
MLA_SERVE_LAYERS = 8   # bfloat16 serving: the dense layer and 7 MoE, 54.4 GiB
MLA_F32_LAYERS = 2     # float32 check: the dense layer and 1 MoE, 20.0 GiB
# (shape, batch on one card, layers; None keeps the depth): each shape's
# sequence length and the width are kept (PERF.md section 4).
# llava-next-mistral-7b's decode_32k runs its 32 layers (13.5 GiB of
# bfloat16 weights, 4.0 GiB of cache a sequence); its train_4k 8 layers
# (float32 weights, gradients and AdamW moments: 30.0 GiB; 32 layers
# would need 108 GiB); its prefill_32k 4 layers for time (~20 s a call
# at 32, 5.9 s at 8). deepseek-v2-236b's decode_32k runs 8 layers (54.4
# GiB of weights, 0.30 GB of cache a sequence); its prefill_32k 2 layers (the
# dense layer and 1 MoE); its train_4k its one dense layer (AdamW state
# 20.7 GiB; with one MoE layer 79.9 GiB, more than the card holds) at 1
# sequence: 1 peaked at 51.41 GiB, 2 ran out of the card's memory in
# the backward of the dense 128-head attention.
VLM_MLA_CUTS = {
    VLM_ARCH: (("train_4k", 2, 8), ("prefill_32k", 1, 4),
               ("decode_32k", 8, None)),
    MLA_ARCH: (("train_4k", 1, 1), ("prefill_32k", 1, 2),
               ("decode_32k", 16, 8)),
}


def lm_vlm_mla(device: str, build, seed: int) -> dict:
    """Phase 26 (``lm_vlm_mla``) on ``device`` (``"cuda"`` on the card;
    on the CPU it rehearses at each arch's smoke config):
    :func:`vlm_arch` for llava-next-mistral-7b, then :func:`mla_arch`
    for deepseek-v2-236b."""
    import torch
    if device != "cpu":
        _free(True)  # earlier phases' closed engines hold tensors in cycles
        print(f"phase 26 starts with "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    out = {VLM_ARCH: vlm_arch(device, build, seed)}
    out[MLA_ARCH] = mla_arch(device, build, seed)
    out["launches"] = {k: sum(out[a]["serve_launches"][k]
                              for a in (VLM_ARCH, MLA_ARCH)) for k in K12}
    return out


def arch_phase(phase: int, arch: str, device: str, build, seed: int, *,
               f32_layers: int | None, cuts, launcher: bool,
               f32_prefix: int | None = None, serve_more=None) -> dict:
    """One arch of phases 26 and 28 (its full config on the card; on the
    CPU its smoke config):

    a. bfloat16 at full depth, the weights drawn in bfloat16, their count
       equal to ``count_params``, through ``ServeEngine`` three ways
       (:func:`serve_three_ways`), then ``serve_more(cfg, params, dev)``
       where given, its dict merged into the result;
    b. float32 at ``f32_layers`` layers (None keeps the depth), the card
       against the CPU (:func:`lm_parity`: prefill 2 x 16 tokens, after
       ``f32_prefix`` patches on the card, and 4 decode steps within
       ``SERVE_F32_TOL``, greedy tokens equal);
    c. its cells cut to ``cuts`` (:func:`run_cells`);
    d. where ``launcher``, the launcher, ``python -m
       repro_torch.launch.serve --arch ARCH``, in process; else a line
       says why not: it draws float32 masters that one card cannot
       hold."""
    import numpy as np
    import torch
    from repro_torch.config.base import get_config, get_smoke_config
    from repro_torch.models import model as lm
    from repro_torch.models.tree import tree_leaves, tree_map
    on_card = device != "cpu"
    dev = torch.device(device)
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are enabled: float32 checks would see TF32 error")
    cfg = get_config(arch) if on_card else get_smoke_config(arch)
    stamp = _stamper(f"{phase} {arch}")

    # -- a. bf16 at full depth through ServeEngine, three ways ---------- #
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev, dtype=torch.bfloat16)
    n_params = sum(x.numel() for x in tree_leaves(params))
    check(n_params == cfg.param_count(),
          f"{arch}: {n_params} parameters, count_params says "
          f"{cfg.param_count()}")
    print(f"{arch} ({cfg.name}): {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.n_heads} heads / {cfg.n_kv_heads} KV of "
          f"{cfg.resolved_head_dim} (groups of "
          f"{cfg.n_heads // cfg.n_kv_heads}), d_ff {cfg.d_ff}, padded vocab "
          f"{cfg.padded_vocab}, qk_norm {cfg.qk_norm}, qkv_bias "
          f"{cfg.qkv_bias}"
          + (f", {cfg.n_frontend_tokens} patch tokens"
             if cfg.frontend == "vision" else "")
          + f"; {n_params:,} parameters drawn in bfloat16 "
          f"({n_params * 2 / 2**30:.2f} GiB) = count_params")
    out = serve_three_ways(cfg, params, build, dev, f"{arch} serve")
    if serve_more is not None:
        out.update(serve_more(cfg, params, dev))
    del params
    _free(on_card)
    stamp("a")

    # -- b. float32, the card against the CPU ---------------------------- #
    cfg32 = dataclasses.replace(cfg, dtype="float32", n_layers=min(
        f32_layers or cfg.n_layers, cfg.n_layers))
    t = time.perf_counter()
    params = lm.init_params(cfg32, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    cpu_params = tree_map(lambda x: x.cpu(), params)
    batch = lm_inputs(cfg32, np.random.default_rng(seed), 2, 16, dev,
                      prefix=f32_prefix if on_card else None)
    errs, same = lm_parity(cfg32, params, cpu_params, batch, dev, steps=4,
                           forward=False)
    del params, cpu_params
    err = max(errs.values())
    prompt = (f"({batch['patches'].shape[1]} patches + 16 tokens)"
              if "patches" in batch else "16 tokens")
    print(f"{arch} float32 at {cfg32.n_layers} of {cfg.n_layers} layers "
          f"({cfg32.param_count() * 4 / 2**30:.2f} GiB), {device} against "
          f"CPU (prefill 2 x {prompt}, 4 decode steps): max abs "
          f"logit error {err:.3e} (bound {SERVE_F32_TOL:g}), greedy tokens "
          f"{'equal' if same else 'DIFFER'}, {time.perf_counter() - t:.1f} s")
    check(err <= SERVE_F32_TOL and same,
          f"{arch} float32 against the CPU: {errs}, tokens equal {same}")
    out["f32_err"] = err
    _free(on_card)
    stamp("b")

    # -- c. the cells on one card ---------------------------------------- #
    out["cells"] = run_cells(arch, cuts, device, seed)
    stamp("c")

    # -- d. the launcher, as a user runs it ------------------------------ #
    if launcher:
        serve_launcher(arch, device)
        _free(on_card)
    else:
        masters = get_config(arch).param_count() * 4 / 2**30
        print(f"launcher (python -m repro_torch.launch.serve --arch {arch} "
              f"--device {device}): not run; it builds ServeEngine(cfg), "
              f"which draws float32 masters as the reference does "
              f"({masters:.1f} GiB at full width, more than one 80 GB card)")
    stamp("d")
    return out


def vlm_arch(device: str, build, seed: int) -> dict:
    """Phase 26 for llava-next-mistral-7b (:func:`arch_phase`): text
    through ``ServeEngine`` three ways (it passes no patches, in the
    reference as in the port), then the 2,880-patch prefix through
    ``prefill``/``decode_step`` (:func:`prefix_serve`); float32 at
    :data:`VLM_F32_LAYERS` layers over :data:`VLM_F32_PATCHES` patches;
    its cells cut to :data:`VLM_MLA_CUTS`; the launcher (its float32
    masters, 27 GiB, fit one card)."""
    def prefix(cfg, params, dev):
        return {"prefix": prefix_serve(cfg, params, dev, seed,
                                       f"{VLM_ARCH} serve with patches")}
    return arch_phase(26, VLM_ARCH, device, build, seed,
                      f32_layers=VLM_F32_LAYERS, f32_prefix=VLM_F32_PATCHES,
                      cuts=VLM_MLA_CUTS[VLM_ARCH], launcher=True,
                      serve_more=prefix)


def mla_arch(device: str, build, seed: int) -> dict:
    """Phase 26 for deepseek-v2-236b (its width on the card, its depth
    cut: 60 layers are 439 GiB in bfloat16):

    a. bfloat16 at :data:`MLA_SERVE_LAYERS` layers, the weights drawn in
       bfloat16 a layer slice at a time, their count equal to
       ``count_params``, through ``ServeEngine`` three ways
       (:func:`serve_three_ways`; MLA's absorbed decode);
    b. float32 at :data:`MLA_F32_LAYERS` layers, the card against the
       CPU (:func:`lm_parity`: prefill 2 x 16 tokens and 4 decode steps,
       every router decision held by :func:`moe_route_tap`), decoding
       once absorbed and once naive (``mla_absorbed_decode``): each
       within ``SERVE_F32_TOL`` of the CPU in the same mode with equal
       greedy tokens, and the card's two runs within ``SERVE_F32_TOL`` of
       each other;
    c. its cells cut to :data:`VLM_MLA_CUTS` (:func:`run_cells`).

    No launcher run: ``launch/serve.py`` builds ``ServeEngine(cfg)``,
    which would draw 878 GiB of float32 masters."""
    import numpy as np
    import torch
    from repro_torch.config.base import get_config, get_smoke_config
    from repro_torch.models import model as lm
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.tree import tree_leaves, tree_map
    arch = MLA_ARCH
    on_card = device != "cpu"
    dev = torch.device(device)
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are enabled: float32 checks would see TF32 error")
    full = get_config(arch) if on_card else get_smoke_config(arch)
    stamp = _stamper(f"26 {arch}")

    # -- a. bf16 at a cut depth through ServeEngine, three ways ---------- #
    cfg = dataclasses.replace(full, n_layers=min(MLA_SERVE_LAYERS,
                                                 full.n_layers))
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev, dtype=torch.bfloat16)
    n_params = sum(x.numel() for x in tree_leaves(params))
    check(n_params == cfg.param_count() and all(
        x.dtype == torch.bfloat16 for x in tree_leaves(params)),
          f"{arch}: {n_params} parameters, count_params says "
          f"{cfg.param_count()}")
    print(f"{arch} ({cfg.name}): {cfg.n_layers} of {full.n_layers} layers "
          f"({cfg.first_dense_layers} dense), d {cfg.d_model}, "
          f"{cfg.n_heads} heads, MLA kv_lora {cfg.kv_lora_rank} / q_lora "
          f"{cfg.q_lora_rank} / nope {cfg.qk_nope_head_dim} / rope "
          f"{cfg.qk_rope_head_dim} / v {cfg.v_head_dim}, "
          f"{cfg.n_experts} experts top-{cfg.top_k} + "
          f"{cfg.n_shared_experts} shared of {cfg.moe_d_ff}, padded vocab "
          f"{cfg.padded_vocab}, {n_params:,} parameters drawn in bfloat16 "
          f"= count_params; "
          + (f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB "
             f"allocated" if on_card else "on the CPU"))
    out = serve_three_ways(cfg, params, build, dev, f"{arch} serve")
    del params
    _free(on_card)
    stamp("a")

    # -- b. float32 at a cut depth: the card against the CPU, two decodes #
    cfg32 = dataclasses.replace(full, dtype="float32",
                                n_layers=min(MLA_F32_LAYERS, full.n_layers))
    t = time.perf_counter()
    params = lm.init_params(cfg32, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    cpu_params = tree_map(lambda x: x.cpu(), params)
    batch = lm_inputs(cfg32, np.random.default_rng(seed), 2, 16, dev)
    n_moe = cfg32.n_layers - cfg32.first_dense_layers
    runs = {}
    chosen = moe_mod.top_k
    for absorbed in (True, False):
        c = dataclasses.replace(cfg32, mla_absorbed_decode=absorbed)
        routes: list = []
        logits: list = []
        moe_mod.top_k = moe_route_tap(moe_mod, c, routes)
        try:
            errs, same = lm_parity(c, params, cpu_params, batch, dev,
                                   steps=4, forward=False, keep=logits)
        finally:
            moe_mod.top_k = chosen
        runs[absorbed] = (errs, same, route_blocks(routes, n_moe, 5), logits)
    del params, cpu_params
    between = max(float((a - b).abs().max())
                  for a, b in zip(runs[True][3], runs[False][3]))
    for absorbed, (errs, same, (equal, dropped, entries), _) in runs.items():
        err = max(errs.values())
        print(f"{arch} float32 at {cfg32.n_layers} layers, "
              f"{'absorbed' if absorbed else 'naive'} decode, {device} "
              f"against CPU (prefill 2 x 16 tokens, 4 decode steps): max "
              f"abs logit error {err:.3e} (bound {SERVE_F32_TOL:g}), greedy "
              f"tokens {'equal' if same else 'DIFFER'}; router decisions "
              f"of {n_moe} MoE layer(s) at the prefill and 4 decode steps "
              f"(capacity {moe_mod.capacity(cfg32, 32)} and "
              f"{moe_mod.capacity(cfg32, 2)} an expert): expert ids and "
              f"drop masks {'identical' if equal else 'DIFFER'}, dropped "
              f"{dropped} of {entries} (token, choice) entries")
        check(err <= SERVE_F32_TOL and same and equal,
              f"{arch} float32 against the CPU (absorbed {absorbed}): "
              f"{errs}, tokens equal {same}, routes equal {equal}")
    print(f"{arch} float32 on {device}: absorbed against naive decode, max "
          f"abs logit error {between:.3e} over the prefill and 4 steps "
          f"(bound {SERVE_F32_TOL:g}); {time.perf_counter() - t:.1f} s")
    check(between <= SERVE_F32_TOL,
          f"{arch}: absorbed and naive decodes differ by {between}")
    out.update(f32_err=max(max(r[0].values()) for r in runs.values()),
               f32_absorbed_vs_naive=between, dropped=runs[True][2][1])
    _free(on_card)
    stamp("b")

    # -- c. the cells on one card ---------------------------------------- #
    out["cells"] = run_cells(arch, VLM_MLA_CUTS[arch], device, seed)
    stamp("c")
    return out


FIGURE_KERNELS = ("bit_transpose32", "run_program_cuda", "maj_n",
                  "charge_share")
# The rows the PERF table sets beside the reference's and the paper's.
FIGURE_ROWS = ("fig03.fracdram_maj3_ddr4_mean",
               "fig14.pulsar_vs_fracdram_gain", "fig16.spatial",
               "fig17.avg_M", "fig17.avg_H", "fig20.bmi", "fig20.knn")


def figures(device: str, build) -> dict:
    """Phase 27 (``figures``) on ``device``: every figure module of
    ``benchmarks/torch_run.py`` (the paper's figures and tables, the
    bank-parallelism and reliability sweeps; ``kernel_bench`` is phase
    29) at the reference's sizes,
    each row held against ``benchmarks/torch_figures_reference.json``:
    exact numbers and every word byte-equal, statistical ones within
    their stored tolerance, host walls skipped. Launch counts are set to
    0 just before the modules run. Prints each module's seconds and
    launches and the worst statistical number against its tolerance,
    writes every row to ``build/figures_rows.csv``, and returns the
    launches and seconds."""
    from benchmarks import common, torch_run
    from repro_torch.core import engine as engine_mod
    from repro_torch.kernels import bit_transpose, charge_share, codegen, maj_n
    reference = torch_run.load_reference()
    on_card = device != "cpu"
    if on_card:
        # The fused programs of Fig 20 and the sweep, recorded on the CPU.
        t = time.perf_counter()
        programs = programs_of(engine_mod, lambda: [
            torch_run.module(n).run(device="cpu")
            for n in ("fig20_realworld", "reliability_sweep")])
        common.drain_counters()
        items = {codegen.build_item(p) for p in programs}
        build.build_many(sorted(items | {
            bit_transpose.build_item(), charge_share.build_item(),
            maj_n.build_item()}))
        print(f"phase 27: {len(programs)} flushes of {len(items)} fused "
              f"programs recorded on the CPU, every kernel built, in "
              f"{time.perf_counter() - t:.1f} s")
    reset_launches(build)
    out = {"seconds": {}}
    names, bad, lines = [], [], ["name,us_per_call,derived"]
    t_all = time.perf_counter()
    for name in torch_run.FIGURE_MODULES:
        before = dict(build.LAUNCHES)
        t = time.perf_counter()
        rows = torch_run.module(name).run(device=device)
        secs = time.perf_counter() - t
        common.drain_counters()
        rose = {k: build.LAUNCHES.get(k, 0) - before.get(k, 0)
                for k in FIGURE_KERNELS}
        worst = (0.0, "")
        for row, us, derived in rows:
            names.append(row)
            lines.append(f'{row},{us},"{derived}"')
            entry = reference.get(row)
            if entry is None:
                bad.append(f"{row}: not a reference row")
                continue
            bad += torch_run.check_row(derived, entry)
            nums = torch_run.split(derived)[1]
            for (field, text), f in zip(nums, entry["fields"]):
                if f["kind"] == "statistical":
                    r = abs(float(text) - float(f["text"])) / f["tol"]
                    if r >= worst[0]:
                        worst = (r, f"{row} {field}={text} (reference "
                                    f"{f['text']}, tol {f['tol']:.4g})")
            if row in FIGURE_ROWS:
                print(f"  {row}: {derived} | reference: {entry['derived']}")
        out["seconds"][name] = secs
        print(f"figures {name}: {len(rows)} rows in {secs:.2f} s, launches "
              f"{rose}" + (f"; worst statistical |d|/tol {worst[0]:.3f}: "
                           f"{worst[1]}" if worst[1] else ""), flush=True)
    out["total_s"] = time.perf_counter() - t_all
    out["launches"] = {k: build.LAUNCHES.get(k, 0) for k in FIGURE_KERNELS}
    csv = ROOT / "build" / "figures_rows.csv"
    csv.parent.mkdir(parents=True, exist_ok=True)
    csv.write_text("\n".join(lines) + "\n")
    check(names == list(reference),
          f"phase 27: rows {names} are not the reference's "
          f"{list(reference)}")
    check(not bad, "phase 27: " + "; ".join(bad))
    if on_card:
        check(all(out["launches"][k] > 0 for k in FIGURE_KERNELS),
              f"phase 27: a kernel never launched {out['launches']}")
    print(f"figures: {len(names)} rows of {len(torch_run.FIGURE_MODULES)} "
          f"modules "
          f"on {device} equal the reference's or lie within their "
          f"tolerance; {out['total_s']:.1f} s, launches {out['launches']}; "
          f"rows in {csv.relative_to(ROOT)}")
    return out


DENSE_ARCHS = ("qwen3-1.7b", "phi3-medium-14b", "qwen2.5-32b")
# float32 check, card against CPU: its depth (None keeps it). qwen3-1.7b
# runs whole (7.59 GiB); phi3-medium-14b and qwen2.5-32b run 2 layers
# (6.8 and 10.2 GB, most of it their embedding and head).
DENSE_F32_LAYERS = {"qwen3-1.7b": None, "phi3-medium-14b": 2,
                    "qwen2.5-32b": 2}
# the serve launcher draws float32 masters (ServeEngine(cfg), as the
# reference does): 7.6 and 54.6 GiB fit one card, qwen2.5-32b's 122.1
# GiB do not.
DENSE_LAUNCHER = ("qwen3-1.7b", "phi3-medium-14b")
# (shape, batch on one card, layers; None keeps the depth): each shape's
# sequence length and the width are kept (PERF.md section 4); bounds
# count the whole weights of the cut config (one_card_bound).
# qwen3-1.7b: train_4k 1 sequence at its 28 layers for time (AdamW
# state 30.4 GiB; 2 peak at 47.9 GiB), prefill_32k 2 layers for time
# (1.5 s a call at 4), decode_32k 8 sequences at 28 layers (28 GiB of
# cache; peak 32.4).
# phi3-medium-14b: train_4k 4 of 40 layers (state 35.6 GiB, peak 47.9;
# 40 would need 218 GiB), prefill_32k 1 layer for time (1.9 s a call at
# 2), decode_32k 4 sequences at 40 layers (27.3 GiB of weights, 25 GiB
# of cache; peak 52.7).
# qwen2.5-32b: train_4k 2 of 64 layers (state 38.0 GiB, peak 52.7),
# prefill_32k 1 layer for time (1.9 s a call at 2), decode_32k 1
# sequence at 64 layers (61.1 GiB of weights, 8 GiB of cache; peak
# 69.1).
DENSE_CUTS = {
    "qwen3-1.7b": (("train_4k", 1, None), ("prefill_32k", 1, 2),
                   ("decode_32k", 8, None)),
    "phi3-medium-14b": (("train_4k", 1, 4), ("prefill_32k", 1, 1),
                        ("decode_32k", 4, None)),
    "qwen2.5-32b": (("train_4k", 1, 2), ("prefill_32k", 1, 1),
                    ("decode_32k", 1, None)),
}


def lm_dense(device: str, build, seed: int) -> dict:
    """Phase 28 (``lm_dense``) on ``device`` (``"cuda"`` on the card; on
    the CPU it rehearses at each arch's smoke config): :func:`arch_phase`
    for qwen3-1.7b, phi3-medium-14b and qwen2.5-32b, in that order, at
    :data:`DENSE_F32_LAYERS`, :data:`DENSE_CUTS` and
    :data:`DENSE_LAUNCHER`."""
    import torch
    if device != "cpu":
        _free(True)  # earlier phases' closed engines hold tensors in cycles
        print(f"phase 28 starts with "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    out = {arch: arch_phase(28, arch, device, build, seed,
                            f32_layers=DENSE_F32_LAYERS[arch],
                            cuts=DENSE_CUTS[arch],
                            launcher=arch in DENSE_LAUNCHER)
           for arch in DENSE_ARCHS}
    out["launches"] = {k: sum(out[a]["serve_launches"][k]
                              for a in DENSE_ARCHS) for k in K12}
    return out


KERNELS = ("bit_transpose32", "run_program_cuda", "maj_n", "bitserial_add",
           "charge_share")
# kernel.* row of benchmarks/torch_kernel_bench.py -> the kernel it
# launches and (bytes it must move, operations it does) at ``words``
# words a plane (the reference's shapes: MAJ-31 at threshold 16, K = 5
# counter planes; 32-bit add; G = words tiles; 32 rows, one pattern).
KERNEL_BENCH_BOUNDS = {
    "kernel.maj31_bitsliced": ("maj_n", lambda w: (32 * w * 4,
                                                   w * 31 * (3 * 5 + 1))),
    "kernel.bitserial_add32": ("bitserial_add", lambda w: (3 * 32 * w * 4,
                                                           5 * 32 * w)),
    "kernel.bit_transpose32": ("bit_transpose32", lambda w: (2 * 32 * w * 4,
                                                             0)),
    "kernel.charge_share32": ("charge_share", lambda w: (65 * w * 4,
                                                         w * (3 * 32 + 1))),
}


def kernel_bench_items() -> list:
    """``(name, source)`` of every kernel phase 29 launches: K1, K3, K4,
    K5 and the fused programs of ``benchmarks/torch_kernel_bench.py``,
    recorded on the CPU at 32 words a plane (a program's structure does
    not depend on its lane count)."""
    from benchmarks import common, torch_kernel_bench as kb
    from repro_torch.core import engine as engine_mod
    from repro_torch.kernels import bit_transpose, charge_share, codegen, maj_n
    # the package exports the kernel's wrapper under the module's name
    k4 = importlib.import_module("repro_torch.kernels.bitserial_add")
    programs = programs_of(engine_mod, lambda: kb.run("cpu", words=32))
    common.drain_counters()
    return sorted({codegen.build_item(p) for p in programs} | {
        bit_transpose.build_item(), k4.build_item(),
        charge_share.build_item(), maj_n.build_item()})


def kernel_bench(device: str, build) -> dict:
    """Phase 29 (``kernel_bench``) on ``device``: the 21 rows of
    ``benchmarks/torch_kernel_bench.py`` (the port's ``kernel_bench``) at
    the reference's sizes on the card (1024 words a plane on the CPU).
    First each ``kernel.*`` row's kernel is held against its plain
    version on the row's inputs (K5 within rtol 1e-5, atol 1e-7 V; the
    others bit-exact, the bit-sliced MAJ also against the oracle), and
    :func:`kernel_bench_items` are built (a no-op when ``main`` has
    built them in the background). Launch counts are set to 0 just
    before ``run``. Checks: the row names, in order, are ``ROWS``;
    ``tools/bench_compare.py``'s row gate against ``BENCH_kernel.json``
    passes; every ``bit_exact``/``stats_match`` is True; on the card K3,
    K4, K5 and K1 launch in the kernel rows and K1 and K2 in the fused
    rows. Prints each row, the
    kernel rows' bounds, the seconds, the launches and the gate's
    fused-vs-eager verdict (a relation of two walls, not checked);
    writes the rows to ``build/BENCH_torch_kernel_h100.json``."""
    import re
    import torch
    from benchmarks import common, torch_kernel_bench as kb
    from repro_torch.kernels import ops, ref
    from tools import bench_compare
    on_card = device != "cpu"
    words = kb.W if on_card else 1024

    # -- the kernels against their plain versions at the rows' shapes --- #
    x = kb.kernel_inputs(device, words)
    oracle = ref.maj_n(x["x32"], 16)
    got = {"maj_n": (ops.maj_n(x["x32"], 16), ref.maj_n_fast(x["x32"], 16)),
           "bitserial_add": (ops.bitserial_add(x["a"], x["b"]),
                             ref.bitserial_add(x["a"], x["b"])),
           "bit_transpose32": (ops.bit_transpose32(x["a"]),
                               ref.bit_transpose32(x["a"]))}
    errs = {k: max_abs_err(*pair) for k, pair in got.items()}
    errs["maj_n_oracle"] = max_abs_err(got["maj_n"][0], oracle)
    k5, k5_plain = (ops.charge_share(x["v"], x["c"], vdd=1.2, c_bl=116.0),
                    ref.charge_share(x["v"], x["c"], vdd=1.2, c_bl=116.0))
    errs["charge_share"] = float((k5 - k5_plain).abs().max())
    check(all(errs[k] == 0 for k in got) and errs["maj_n_oracle"] == 0
          and torch.allclose(k5, k5_plain, rtol=1e-5, atol=1e-7),
          f"phase 29: a kernel differs from its plain version {errs}")
    del x, oracle, got, k5, k5_plain
    if on_card:
        t = time.perf_counter()
        items = kernel_bench_items()
        build.build_many(items)
        slowest = max(items, key=lambda it: build.BUILDS[it[0]]["seconds"])
        print(f"phase 29: kernels equal their plain versions at the rows' "
              f"shapes {errs}; {len(items)} libraries recorded on the CPU "
              f"and built in {time.perf_counter() - t:.1f} s (the slowest "
              f"nvcc {slowest[0]}, {len(slowest[1]):,} bytes of source: "
              f"{build.BUILDS[slowest[0]]['seconds']:.1f} s)")

    # -- the module, its launches split at the kernel rows' end --------- #
    after_kernel_rows = {}
    real_kernel_rows = kb._kernel_rows

    def kernel_rows(*args):
        rows = real_kernel_rows(*args)
        after_kernel_rows.update(build.LAUNCHES)
        return rows

    reset_launches(build)
    kb._kernel_rows = kernel_rows
    try:
        t = time.perf_counter()
        rows = kb.run(device, words=words)
        secs = time.perf_counter() - t
    finally:
        kb._kernel_rows = real_kernel_rows
    launches = {k: build.LAUNCHES.get(k, 0) for k in KERNELS}
    in_kernel_rows = {k: after_kernel_rows.get(k, 0) for k in KERNELS}
    in_fused_rows = {k: launches[k] - in_kernel_rows[k] for k in KERNELS}
    path = ROOT / "build" / "BENCH_torch_kernel_h100.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    common.emit_bench_json("torch_kernel_bench", rows, str(path))
    failures = bench_compare.compare(
        bench_compare.load_bench(str(ROOT / "BENCH_kernel.json")),
        bench_compare.load_bench(str(path)), check_rows_only=True)
    row_failures = [f for f in failures if f.startswith("rows ")]
    us = {name: u for name, u, _ in rows}
    out = {"seconds": secs, "launches": launches, "us": us, "ms": {},
           "bound_ms": {}, "bound_by": {}, "errs": errs}
    for name, u, derived in rows:
        print(f"  {name},{u},\"{derived}\"")
    for name, (kernel, work) in KERNEL_BENCH_BOUNDS.items():
        nbytes, n_ops = work(words)
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        by_ops = n_ops / (FP32_OPS_PER_S if kernel == "charge_share"
                          else ALU_OPS_PER_S) * 1e3
        out["ms"][kernel] = us[name] / 1e3
        out["bound_ms"][kernel] = max(by_bytes, by_ops)
        out["bound_by"][kernel] = "bytes" if by_bytes >= by_ops \
            else "operations"
        share = out["bound_ms"][kernel] * 1e3 / us[name]
        print(f"  {name}: {us[name] / 1e3:.4f} ms a launch, bound "
              f"{out['bound_ms'][kernel]:.4f} ms ({out['bound_by'][kernel]}"
              f"; {nbytes} bytes), {share:.0%} of it")
    flags = [m for _, _, d in rows
             for m in re.findall(r"(?:bit_exact|stats_match)\S*=(\w+)", d)]
    check(list(us) == list(kb.ROWS),
          f"phase 29: rows {list(us)} are not the reference's {kb.ROWS}")
    check(not row_failures, "phase 29: " + "; ".join(row_failures))
    check(len(flags) == 8 and all(f == "True" for f in flags),
          f"phase 29: bit_exact/stats_match flags {flags}")
    if on_card:
        check(all(in_kernel_rows[k] > 0 for k in (
            "maj_n", "bitserial_add", "charge_share", "bit_transpose32"))
              and all(in_fused_rows[k] > 0
                      for k in ("bit_transpose32", "run_program_cuda")),
              f"phase 29: kernel rows launched {in_kernel_rows}, the "
              f"fused rows {in_fused_rows}")
    speed = [f for f in failures if f not in row_failures]
    print(f"kernel_bench: {len(rows)} rows on {device} in {secs:.1f} s, "
          f"names and order the reference's, bench_compare's row gate "
          f"against BENCH_kernel.json passes, every bit_exact/stats_match "
          f"True; launches {launches} (kernel rows {in_kernel_rows}, fused "
          f"rows {in_fused_rows}); rows in {path.relative_to(ROOT)}")
    print(f"kernel_bench fused vs eager (bench_compare, not checked): "
          + ("; ".join(speed) if speed else
             "every app.*_fused row at least as fast as its eager row"))
    return out


ALONE = ("lm_serve", "lm_cells_sharded", "lm_subquadratic", "lm_moe_encdec",
         "lm_vlm_mla", "figures", "lm_dense", "kernel_bench")


def run_alone(argv: list[str]) -> int:
    """``--only NAME``: one phase of :data:`ALONE` by itself (phases 20,
    24-29 on one card; phase 23 over every visible card, its
    fault controls included when there are several), the kernels it
    launches built first; no result line."""
    if len(argv) != 2 or argv[0] != "--only" or argv[1] not in ALONE:
        print(f"usage: chip_smoke.py [--only {'|'.join(ALONE)}]",
              file=sys.stderr)
        return 2
    from repro_torch.config.base import get_smoke_config
    from repro_torch.kernels import _build, bit_transpose, codegen
    from repro_torch.pum import capture as capture_mod
    from repro_torch.serve.engine import ServeEngine
    t = time.perf_counter()
    if argv[1] == "figures":
        figures("cuda", _build)
    elif argv[1] == "kernel_bench":
        kernel_bench("cuda", _build)
    elif argv[1] != "lm_cells_sharded":
        programs = programs_of(capture_mod, lambda: ServeEngine(
            get_smoke_config(SERVE_ARCH), max_batch=4, max_len=256,
            eos_id=-1, device="cpu").close())
        _build.build_many([bit_transpose.build_item()]
                          + [codegen.build_item(p) for p in programs])
        if argv[1] == "lm_serve":
            lm_serve("cuda", _build, programs[0], SEED)
        elif argv[1] == "lm_subquadratic":
            lm_subquadratic("cuda", _build, SEED)
        elif argv[1] == "lm_moe_encdec":
            lm_moe_encdec("cuda", _build, SEED)
        elif argv[1] == "lm_vlm_mla":
            lm_vlm_mla("cuda", _build, SEED)
        else:
            lm_dense("cuda", _build, SEED)
    else:
        _build.build_many([bit_transpose.build_item()])
        lm_cells_sharded("cuda", _build, SEED)
    print(f"[time] {argv[1]} alone: {time.perf_counter() - t:.1f} s")
    return 0


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
        from repro_torch.config.base import get_smoke_config
        from repro_torch.pum import capture as capture_mod
        from repro_torch.serve.engine import ServeEngine
        from tools import maj_n_timing
        k4 = importlib.import_module("repro_torch.kernels.bitserial_add")
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e}); run "
              f"from the root of a checkout", file=sys.stderr)
        return 2

    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    if len(sys.argv) > 1:
        return run_alone(sys.argv[1:])
    cuda = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    results = {}
    clock = PhaseClock()

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
    # The serve path's captured stop predicate, recorded on the CPU by a
    # smoke-size engine with the launcher's max_batch/max_len/eos.
    serve_programs = programs_of(capture_mod, lambda: ServeEngine(
        get_smoke_config(SERVE_ARCH), max_batch=4, max_len=256, eos_id=-1,
        device="cpu").close())
    check(len(serve_programs) == 1, f"{len(serve_programs)} stop programs")
    t0 = time.perf_counter()
    _build.build_many([bit_transpose.build_item(), charge_share.build_item(),
                       maj_n.build_item(), k4.build_item(),
                       maj_n_timing.empty_item()]
                      + [codegen.build_item(p) for p in
                         list(main_programs.values()) + random_programs
                         + serve_programs])
    build_s = time.perf_counter() - t0
    print(f"build: {len(_build.BUILDS)} libraries in {build_s:.1f} s "
          f"(parallel nvcc)")
    for name, info in sorted(_build.BUILDS.items()):
        print(f"  {name}: {info['seconds']:.1f} s, "
              f"{_build.ptxas_summary(name)}")
    # Phase 29's kernels build while phases 2-28 run: its width-64
    # mul/div program is ~2.7 MB of generated source, ~1 min of nvcc.
    kb_build = threading.Thread(target=_build.build_many,
                                args=(kernel_bench_items(),))
    kb_build.start()
    clock.stamp("1")

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
    clock.stamp("2")

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

    def k3_hold(x, thresholds, oracle_t, plain_on_cpu=False):
        """One launch a threshold, bit-exact against ``ref.maj_n_fast`` on
        the same planes (on a CPU copy where that is quicker: it is a
        few small ops a plane), and at ``oracle_t`` against the unpacking
        oracle ``ref.maj_n`` too."""
        nonlocal k3_err
        n, w = x.shape
        xc = x.cpu() if plain_on_cpu else x
        for t in thresholds:
            got = maj_n.maj_n_cuda(x, t)
            err = max_abs_err(got.to(xc.device), ref.maj_n_fast(xc, t))
            k3_err = max(k3_err, err)
            check(err == 0, f"maj_n kernel disagrees at N={n} W={w} "
                            f"threshold {t}")
        got = maj_n.maj_n_cuda(x, oracle_t)
        check(torch.equal(got, ref.maj_n(x, oracle_t)),
              f"maj_n kernel disagrees with the unpacking oracle at N={n} "
              f"W={w} threshold {oracle_t}")

    def k3_planes(n, w):
        x = torch.randint(-2**31, 2**31 - 1, (n, w), dtype=torch.int32,
                          device=cuda)
        x[:, :7] = -1
        return x

    for n in (3, 5, 7, 32):
        for w in (1001, 65536, 1 << 21):
            k3_hold(k3_planes(n, w), range(1, n + 1), n)
        print(f"K3 maj_n N={n}: bit-exact at W = 1001, 65536, 2M, every "
              f"threshold")
    # The chip model's votes: [N, 2048], a PAPER_MODULE row.
    for n in range(1, 33):
        k3_hold(k3_planes(n, 2048), range(1, n + 1), n // 2 + 1,
                plain_on_cpu=True)
    print("K3 maj_n at the chip model's [N, 2048], N = 1..32: bit-exact at "
          "every threshold (the plain version on a CPU copy), against the "
          "oracle at N // 2 + 1")
    for n in (33, 35, 64, 255):
        k3_hold(k3_planes(n, 65536), sorted({1, n // 2 + 1, n}), n // 2 + 1)
    for n in (33, 255):
        for w in (1, 31, 2049):
            k3_hold(k3_planes(n, w), sorted({1, n // 2 + 1, n}), n // 2 + 1,
                    plain_on_cpu=True)
    for w in (1, 31, 2049):
        x = k3_planes(4096, w)
        for t in (1, 2049, 4096):
            check(torch.equal(maj_n.maj_n_cuda(x, t), ref.maj_n(x, t)),
                  f"maj_n kernel disagrees with the oracle at N=4096 W={w} "
                  f"threshold {t}")
    k3_hold(x, [2049], 2049, plain_on_cpu=True)
    print("K3 maj_n past 32 planes: bit-exact at N = 33, 35, 64, 255 (W = "
          "65536) and N = 33, 255 (W = 1, 31, 2049) at thresholds 1, "
          "N // 2 + 1, N; N = 4096 at W = 1, 31, 2049 against the oracle "
          "at thresholds 1, 2049, 4096 and against the plain version at "
          "W = 2049, threshold 2049")
    # Timed with device_us (CUDA events, raw launches queued behind a
    # sleep, inputs rotated past 128 MiB) at the four main-path shapes.
    k3_recs = maj_n_timing.measure(
        maj_n.library(), _build.load(*maj_n_timing.empty_item(),
                                     "empty_launch",
                                     maj_n_timing.EMPTY_ARGTYPES))
    k3_floors = k3_recs.pop()
    for r in k3_recs:
        print(f"K3 at {r['shape']} ({r['what']}, threshold "
              f"{r['threshold']}, geometry {r['geometry']}): "
              f"{r['us']:.3f} us, bound {r['bound_us']:.4f} us "
              f"({r['bound_by']}), {r['share']:.1%} of it")
    print(f"K3 floors on the same timer ({smi}): copy_ of 4 MiB into 4 MiB "
          f"{k3_floors['copy_us']:.3f} us (the bytes of [31, 65536]), of "
          f"16 MiB into 16 MiB {k3_floors['copy_vote_us']:.3f} us (those "
          f"of [3, 2M]), an empty kernel with K3's [31, 2048] grid "
          f"{k3_floors['empty_us']:.3f} us")
    vote = next(r for r in k3_recs if r["what"] == "replica_vote")
    k3_n, k3_w = vote["shape"]
    x = k3_planes(k3_n, k3_w)
    k3_ms = vote["us"] / 1e3
    k3_plain = cuda_ms(lambda: ref.maj_n_fast(x, 2), 20)
    k3_bound = vote["bound_us"] / 1e3
    k3_bound_by = vote["bound_by"]
    print(f"K3 at N={k3_n} W={k3_w} (a 3-replica vote of 2M lanes): kernel "
          f"{k3_ms:.4f} ms, plain {k3_plain:.4f} ms, bound {k3_bound:.4f} "
          f"ms ({(k3_n + 1) * k3_w * 4} bytes)")

    # -- 3d. bit-serial add kernel vs its plain version ------------------ #
    k4_err = 0
    for width in (1, 8, 32, 64):
        for w in (1001, 65536):
            a = torch.randint(-2**31, 2**31 - 1, (width, w),
                              dtype=torch.int32, device=cuda)
            b = torch.randint(-2**31, 2**31 - 1, (width, w),
                              dtype=torch.int32, device=cuda)
            a[:, :3] = -1  # carries ripple through every plane
            got = k4.bitserial_add_cuda(a, b)
            want = ref.bitserial_add(a, b)
            torch.cuda.synchronize()
            err = max_abs_err(got, want)
            k4_err = max(k4_err, err)
            check(err == 0, f"bitserial_add kernel disagrees at width "
                            f"{width} W={w}")
        print(f"K4 bitserial_add width {width}: bit-exact at W = 1001, 65536")
    k4_lib = k4.library()
    k4_times = {}
    for width in (32, 64):
        k4_w = 65536

        def k4_set():
            a, b = (torch.randint(-2**31, 2**31 - 1, (width, k4_w),
                                  dtype=torch.int32, device=cuda)
                    for _ in range(2))
            return a, b, torch.empty_like(a)

        k4_sets = rotation(k4_set, 3 * width * k4_w * 4)
        ms = cuda_ms(cycle_launch(
            k4_lib, k4.ENTRY,
            [(a.data_ptr(), b.data_ptr(), o.data_ptr(), width, k4_w,
              _build.stream_of(a)) for a, b, o in k4_sets]), 200)
        for a, b, o in k4_sets:
            check(torch.equal(o, ref.bitserial_add(a, b)),
                  "bitserial_add kernel disagrees in the timing run")
        a, b, _ = k4_sets[0]
        plain = cuda_ms(lambda: ref.bitserial_add(a, b), 5, rounds=3)
        nbytes = 3 * width * k4_w * 4
        bound_b = nbytes / HBM_BYTES_PER_S * 1e3
        bound_o = 5 * width * k4_w / ALU_OPS_PER_S * 1e3
        k4_times[width] = (ms, plain, max(bound_b, bound_o),
                           "bytes" if bound_b >= bound_o else "operations")
        print(f"K4 at [{width}, {k4_w}] ({width}-bit add of 2M lanes): "
              f"kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
              f"{max(bound_b, bound_o):.4f} ms ({nbytes} bytes)")
        del k4_sets, a, b
    del k5_sets, x, v, c
    clock.stamp("3")

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
    clock.stamp("4")

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
    clock.stamp("6")

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
    clock.stamp("7")

    # -- 8. the reliability path: injected fused flushes ----------------- #
    rel_launches = collections.Counter()
    rel_cases = {}
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
        rel_cases[label] = (rcfg, args)
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
    clock.stamp("8")

    # -- 9. the chip model at the paper's module geometry ---------------- #
    for k in list(_build.LAUNCHES):
        _build.LAUNCHES[k] = 0
    chip, alu, reports, chip_s = chip_model_run("cuda", SEED)
    chip_launches = dict(_build.LAUNCHES)
    n_apa = sum(1 for name, _ in chip.stats.trace
                if name.startswith("apa_maj"))
    check(chip_launches.get("maj_n", 0) == n_apa > 0,
          f"chip model: {chip_launches.get('maj_n', 0)} maj_n launches for "
          f"{n_apa} APAs")
    check(chip_launches.get("bitserial_add", 0) > 0,
          "chip model: bitserial_add never launched")
    host_chip, host_alu, host_reports, host_s = chip_model_run("cpu", SEED)
    check(dataclasses.asdict(chip.stats) == dataclasses.asdict(host_chip.stats),
          "chip model: OpStats differ between the card and the CPU")
    check(alu.op_counts == host_alu.op_counts,
          "chip model: ALU op_counts differ between the card and the CPU")
    check(reports == host_reports,
          "chip model: MAJ reports differ between the card and the CPU")
    check(torch.equal(chip.banks[0].cpu(), host_chip.banks[0])
          and np.array_equal(chip.neutral, host_chip.neutral),
          "chip model: bank 0 differs between the card and the CPU")
    st = {k: v for k, v in dataclasses.asdict(chip.stats).items()
          if k != "trace"}
    print(f"chip model PAPER_MODULE (1 GiB of banks on the card), mfr H: "
          f"MAJ3 at N_RG 4/8/16/32, MAJ5 at 32, Multi-RowInit and "
          f"Bulk-Write of 16, ALU add32 over 65536 lanes (= bitserial_add "
          f"and (a + b) mod 2**32), mul8, mul16, div8, div16: all equal the "
          f"host; {chip.stats.n_ops} chip commands, {n_apa} APAs; card "
          f"{chip_s:.2f} s, CPU {host_s:.2f} s; OpStats, op_counts, reports "
          f"and bank 0 equal the CPU run; launches {chip_launches}")
    print(f"  OpStats: {st}")
    print(f"  op_counts: {alu.op_counts}")
    clock.stamp("9")

    # -- 10. cold-boot destruction of one PAPER_MODULE bank -------------- #
    bank_shape = tuple(chip.banks.shape[1:])
    gen_cuda = torch.Generator(device=cuda).manual_seed(SEED)
    gen_cpu = torch.Generator().manual_seed(SEED)
    card = destruction_run(chip, lambda: torch.randint(
        -2**31, 2**31 - 1, bank_shape, dtype=torch.int32, device=cuda,
        generator=gen_cuda))
    on_cpu = destruction_run(host_chip, lambda: torch.randint(
        -2**31, 2**31 - 1, bank_shape, dtype=torch.int32,
        generator=gen_cpu))
    for method, (rep, sec) in card.items():
        check(rep == on_cpu[method][0],
              f"destruction {method}: report differs from the CPU run")
        print(f"destruction {method} of bank 1 ({bank_shape[0]} rows): "
              f"{rep}, card {sec:.2f} s, CPU {on_cpu[method][1]:.2f} s, "
              f"report equal to the CPU run")
    del chip, host_chip, alu, host_alu
    clock.stamp("10")

    # -- 11. the sim backend through pum.device(backend="sim") ----------- #
    for k in list(_build.LAUNCHES):
        _build.LAUNCHES[k] = 0
    sim_t0 = time.perf_counter()
    sim_wall = {}
    for width in (8, 16, 32, 64):
        mask = np.uint64(2**64 - 1 if width == 64 else (1 << width) - 1)
        lanes = min(pum.EngineConfig().row_bits, 2048)  # one sim chip row
        a = rng.integers(0, int(mask), lanes, dtype=np.uint64, endpoint=True)
        b = rng.integers(0, int(mask), lanes, dtype=np.uint64, endpoint=True)
        b[::7] = 0  # zero-divisor lanes
        bs = np.maximum(b, 1)
        want = {"+": (a + b) & mask, "-": (a - b) & mask, "&": a & b,
                "|": a | b, "^": a ^ b, "*": (a * b) & mask,
                "//": np.where(b == 0, 0, a // bs),
                "%": np.where(b == 0, 0, a % bs)}
        t = time.perf_counter()
        dev, got = sim_run(pum, "cuda", width, a, b)
        sim_wall[width] = time.perf_counter() - t
        check(dev.engine._alu.chip.device.type == "cuda",
              "sim: the chip is not on the card")
        host, got_cpu = sim_run(pum, "cpu", width, a, b)
        for name, _ in SIM_OPS:
            if (width, name) in SIM_RAISES:
                check(isinstance(got[name], str) and "out of rows" in got[name]
                      and got_cpu[name] == got[name],
                      f"sim width {width} {name}: expected the reference's "
                      f"out-of-rows error on both, got {got[name]!r}")
            else:
                check(isinstance(got[name], np.ndarray)
                      and np.array_equal(got[name], want[name])
                      and np.array_equal(got_cpu[name], want[name]),
                      f"sim width {width} {name}: differs from NumPy")
        check(dev.stats.as_dict() == host.stats.as_dict(),
              f"sim width {width}: EngineStats differ from the CPU device")
        check(dataclasses.asdict(dev.engine._alu.chip.stats)
              == dataclasses.asdict(host.engine._alu.chip.stats),
              f"sim width {width}: chip OpStats differ from the CPU device")
        print(f"sim backend width {width} ({lanes} lanes): "
              + ", ".join(n for n, _ in SIM_OPS if (width, n) not in SIM_RAISES)
              + " equal NumPy; "
              + (", ".join(n for n, _ in SIM_OPS if (width, n) in SIM_RAISES)
                 + " run out of rows on both; " if width >= 32 else "")
              + f"EngineStats equal the CPU device; card "
              f"{sim_wall[width]:.2f} s, {dev.engine._alu.chip.stats.n_ops} "
              f"chip commands")
    sim_launches = dict(_build.LAUNCHES)
    check(sim_launches.get("maj_n", 0) > 0, "sim: maj_n never launched")
    print(f"sim backend: {time.perf_counter() - sim_t0:.1f} s (card and CPU), "
          f"launches {sim_launches}")
    clock.stamp("11")

    # -- 12. the controller: controller-priced flushes ------------------ #
    from repro_torch.controller import retarget_program
    from repro_torch.core import engine as engine_mod
    from repro_torch.core.cost_model import CostModel
    from repro_torch.telemetry import (check_timing_invariants,
                                       derive_port_counters)
    ops16 = [rng.integers(0, 2**32, n2m, dtype=np.uint64) for _ in range(3)]
    want16 = prog16_numpy(*ops16)
    reset_launches(_build)
    cdev = pum.device(controller="auto")
    check(cdev.torch_device.type == "cuda", "controller device not on cuda")
    mc = cdev.engine.controller
    t = time.perf_counter()
    out = prog16(cdev, *ops16)
    ctrl_record_s = time.perf_counter() - t
    got = out.to_numpy()
    ctrl_first_s = time.perf_counter() - t
    with pum.profile(cdev) as tr:
        t = time.perf_counter()
        again = prog16(cdev, *ops16).to_numpy()
        ctrl_warm_s = time.perf_counter() - t
    ctrl_launches = dict(_build.LAUNCHES)
    host = pum.device(controller="auto", device="cpu")
    for _ in range(2):
        host_out = prog16(host, *ops16).to_numpy()
    check(np.array_equal(got, want16) and np.array_equal(again, want16)
          and np.array_equal(host_out, want16),
          "controller prog16: differs from NumPy")
    check(cdev.stats.as_dict() == host.stats.as_dict(),
          f"controller prog16: EngineStats differ from the CPU device "
          f"({cdev.stats} vs {host.stats})")
    check(cdev.stats.refresh_stall_ns > 0,
          "controller prog16: no refresh stall priced")
    check(all(ctrl_launches.get(k, 0) > 0 for k in K12),
          f"controller prog16: kernel launches did not rise "
          f"({ctrl_launches})")
    print(f"controller prog16 2M lanes (controller='auto', 16 banks): "
          f"bit-exact vs NumPy, EngineStats equal to the CPU device "
          f"{cdev.stats}; first record {ctrl_record_s:.3f} s (batch_cost "
          f"of {len(mc._batch_cache)} configurations), first flush done at "
          f"{ctrl_first_s:.3f} s, warm {ctrl_warm_s:.4f} s, launches "
          f"{ctrl_launches} (2 flushes)")
    print("  warm flush spans (ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in span_ms(tr).items()))

    rcfg, args = rel_cases["prog16 2M lanes"]
    reset_launches(_build)
    idev = pum.device(controller=mc, reliability=rcfg)
    t = time.perf_counter()
    got = prog16(idev, *args).to_numpy()
    inj_ctrl_s = time.perf_counter() - t
    ctrl_inj_launches = dict(_build.LAUNCHES)
    ihost = pum.device(controller="auto", reliability=rcfg, device="cpu")
    host_out = prog16(ihost, *args).to_numpy()
    counters = {k: v for k, v in idev.counters.as_dict()["counters"].items()
                if k.startswith("reliability.")}
    host_counters = {
        k: v for k, v in ihost.counters.as_dict()["counters"].items()
        if k.startswith("reliability.")}
    want = prog16_numpy(*args)
    check(np.array_equal(got, want) and np.array_equal(host_out, want),
          "controller injected prog16: differs from NumPy")
    check(counters == host_counters,
          f"controller injected prog16: reliability counters differ from "
          f"the CPU ({counters} vs {host_counters})")
    check(idev.stats.as_dict() == ihost.stats.as_dict(),
          "controller injected prog16: EngineStats differ from the CPU")
    check(counters.get("reliability.corrected_bits", 0) > 0,
          f"controller injected prog16: nothing corrected ({counters})")
    check(all(ctrl_inj_launches.get(k, 0) > 0 for k in K12 + ("maj_n",)),
          f"controller injected prog16: kernel launches did not all rise "
          f"({ctrl_inj_launches})")
    print(f"controller injected prog16 2M lanes: bank order "
          f"{idev.reliability.bank_order(16)}, bit-exact, counters and "
          f"EngineStats equal to the CPU {idev.stats}, {inj_ctrl_s:.3f} s, "
          f"launches {ctrl_inj_launches}")
    print(f"  reliability counters: {counters}")

    unit = CostModel(row_bits=65536).maj_unit_programs(3, 8)
    n_ports, n_maj = 8, 32
    streams = [[retarget_program(prog, (i * n_ports + p) % 16)
                for i in range(n_maj // n_ports) for prog in unit]
               for p in range(n_ports)]
    t = time.perf_counter()
    xtr = mc.schedule_concurrent(streams)
    xbar_s = time.perf_counter() - t
    viol = check_timing_invariants(xtr)
    check(viol == [], f"crossbar: timing violations {viol[:3]}")
    serial_ns = sum(mc.schedule(s).total_ns for s in streams)
    port_counters = derive_port_counters(xtr).as_dict()["counters"]
    print(f"crossbar 8 ports x {n_maj // n_ports} MAJ3@8 ops over 16 banks: "
          f"makespan {xtr.total_ns:.2f} ns, serial sum {serial_ns:.2f} ns, "
          f"overlap {serial_ns / xtr.total_ns:.3f}x, 0 violations, "
          f"{xtr.n_refreshes} refreshes, {xbar_s:.3f} s on the host")
    print(f"  derive_port_counters: {port_counters}")
    clock.stamp("12")

    # -- 13. client contexts and flush_async ----------------------------- #
    n_clients = 8
    client_ops = [[rng.integers(0, 2**32, n2m, dtype=np.uint64)
                   for _ in range(3)] for _ in range(n_clients)]
    client_want = [prog16_numpy(*o) for o in client_ops]
    adev = pum.device(controller=mc)
    sdev = pum.device(controller=mc)
    side = torch.cuda.Stream()
    side_handles = []
    real_stream_of = _build.stream_of

    def stream_of(x):  # which stream the side client's kernels ran on
        h = real_stream_of(x)
        if threading.current_thread().name.startswith("pum-flush"):
            side_handles.append(h)
        return h

    def async_round():
        outs = [None] * n_clients
        errors = []
        barrier = threading.Barrier(n_clients)

        def client(i):
            try:
                barrier.wait(timeout=60)
                with adev.client(f"c{i}"):
                    if i == 0:
                        with torch.cuda.stream(side):
                            outs[i] = prog16(adev, *client_ops[i])
                            adev.flush_async().result(timeout=300)
                    else:
                        outs[i] = prog16(adev, *client_ops[i])
                        adev.flush_async().result(timeout=300)
                outs[i] = outs[i].to_numpy()
            except Exception as e:  # re-raised on the main thread
                errors.append((i, e))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n_clients)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        check(not any(th.is_alive() for th in threads),
              "async clients hung")
        if errors:
            raise errors[0][1]
        return outs, wall

    def sync_round():
        t0 = time.perf_counter()
        outs = []
        for i in range(n_clients):
            with sdev.client(f"c{i}"):
                outs.append(prog16(sdev, *client_ops[i]).to_numpy())
        return outs, time.perf_counter() - t0

    reset_launches(_build)
    _build.stream_of = stream_of
    try:
        a_outs, a_cold = async_round()
        async_launches = dict(_build.LAUNCHES)
        a_outs2, a_warm = async_round()
    finally:
        _build.stream_of = real_stream_of
    s_outs, s_cold = sync_round()
    s_outs2, s_warm = sync_round()
    for i in range(n_clients):
        check(np.array_equal(a_outs[i], client_want[i])
              and np.array_equal(a_outs2[i], client_want[i])
              and np.array_equal(s_outs[i], client_want[i])
              and np.array_equal(s_outs2[i], client_want[i]),
              f"client c{i}: output differs from NumPy")
    check(adev.stats == sdev.stats,
          f"async clients: merged EngineStats differ from the serial run "
          f"({adev.stats} vs {sdev.stats})")
    check(sorted(adev.engine._stats_shards) == sorted(
        sdev.engine._stats_shards), "async clients: shard keys differ")
    check(side.cuda_stream in side_handles,
          "the side-stream client's flush did not launch on its stream")
    check(all(async_launches.get(k, 0) >= n_clients for k in K12),
          f"async clients: launches {async_launches}")
    per_flush = {k: async_launches[k] / n_clients for k in K12}
    print(f"client contexts: {n_clients} threads x prog16 2M lanes, "
          f"flush_async (client c0 under a side CUDA stream), bit-exact vs "
          f"NumPy, merged EngineStats equal to the serial run {adev.stats}; "
          f"async wall {a_cold:.3f} s cold / {a_warm:.3f} s warm, sync on "
          f"one thread {s_cold:.3f} s cold / {s_warm:.3f} s warm; launches "
          f"{async_launches} ({per_flush} per flush)")
    del adev, sdev, client_ops, client_want, a_outs, a_outs2, s_outs, s_outs2
    clock.stamp("13")

    # -- 14. capture ----------------------------------------------------- #
    uploads = []
    real_upload = engine_mod._upload

    def counting_upload(wire, device):
        uploads.append(wire.nbytes)
        return real_upload(wire, device)

    capture_launches = collections.Counter()
    for label, n, kw in (("2M", n2m, {}),
                         ("32M", 16 * n2m, {"flush_memory_bytes": None})):
        ops_c = ops16 if n == n2m else [
            rng.integers(0, 2**32, n, dtype=np.uint64) for _ in range(3)]
        want = want16 if n == n2m else prog16_numpy(*ops_c)
        kdev = pum.device(controller=mc, **kw)
        rdev = pum.device(controller=mc, **kw)
        # the warm uncaptured flush of the same size
        for _ in range(2):
            t = time.perf_counter()
            r = prog16(rdev, *ops_c).to_numpy()
            flush_s = time.perf_counter() - t
        check(np.array_equal(r, want), f"capture {label}: flush differs")
        prog = kdev.capture(lambda x, y, z: prog16(kdev, x, y, z),
                            name=f"prog16_{label}")
        reset_launches(_build)
        engine_mod._upload = counting_upload
        try:
            uploads.clear()
            t = time.perf_counter()
            first = prog(*ops_c)
            first_s = time.perf_counter() - t
            first_uploads = len(uploads)
            replay_s, replay_uploads = [], []
            with pum.profile(kdev) as tr:
                for _ in range(3):
                    uploads.clear()
                    before = _build.LAUNCHES["run_program_cuda"]
                    t = time.perf_counter()
                    out = prog(*ops_c)
                    replay_s.append(time.perf_counter() - t)
                    replay_uploads.append(len(uploads))
                    check(_build.LAUNCHES["run_program_cuda"] == before + 1,
                          f"capture {label}: a replay did not launch the "
                          f"fused-program kernel exactly once")
                    check(np.array_equal(out, want),
                          f"capture {label}: a replay differs from NumPy")
        finally:
            engine_mod._upload = real_upload
        capture_launches.update(_build.LAUNCHES)
        names = {name for name, *_ in tr.events}
        check(not names & {"flush.record", "flush.optimize"},
              f"capture {label}: a replay recorded or optimized ({names})")
        check(np.array_equal(first, want), f"capture {label}: first call "
              f"differs from NumPy")
        check(prog.n_records == 1 and prog.n_replays == 3,
              f"capture {label}: {prog.n_records} records, "
              f"{prog.n_replays} replays")
        for _ in range(2):  # re-record: rdev now holds 4 recordings
            prog16(rdev, *ops_c).to_numpy()
        check(kdev.stats == rdev.stats,
              f"capture {label}: stats differ from re-recording "
              f"({kdev.stats} vs {rdev.stats})")
        print(f"capture prog16 {label} lanes: replays equal NumPy, 1 "
              f"recording, stats equal to re-recording, 1 K2 launch and no "
              f"record/optimize span per replay; first call {first_s:.4f} s "
              f"({first_uploads} uploads), warm replay {replay_s[-1]:.4f} s "
              f"(replays {[round(x, 4) for x in replay_s]}, uploads per "
              f"replay {replay_uploads}), warm uncaptured flush "
              f"{flush_s:.4f} s")
        del kdev, rdev, prog, ops_c, want
    print(f"capture launches (3 replays at 2M and at 32M): "
          f"{dict(capture_launches)}")
    clock.stamp("14")

    # -- 15-19. Fig 20, golden fig20, pum_database, autotune ------------- #
    slice5 = apps_and_autotune(pum, "cuda", ops16, want16, SEED,
                               rel_cases["prog16 2M lanes"][0])
    clock.stamp("15-19")

    # -- 20. the LM serve path ------------------------------------------ #
    serve = lm_serve("cuda", _build, serve_programs[0], SEED)
    clock.stamp("20")

    # -- 21. the LM train path ------------------------------------------ #
    train = lm_train("cuda", _build, SEED)
    clock.stamp("21")

    # -- 22. launch and distributed: shard-words, the LM cells ---------- #
    reset_launches(_build)
    shard = launch_and_shard("cuda", _build, SEED)
    clock.stamp("22")

    # -- 23. the LM cells across ranks under their shardings ---------- #
    sharded = lm_cells_sharded("cuda", _build, SEED)
    clock.stamp("23")

    # -- 24. the sub-quadratic family at full width --------------------- #
    subq = lm_subquadratic("cuda", _build, SEED)
    clock.stamp("24")

    # -- 25. the MoE and encoder-decoder families at full width --------- #
    moe_encdec = lm_moe_encdec("cuda", _build, SEED)
    clock.stamp("25")

    # -- 26. the VLM and MLA families at full width --------------------- #
    vlm_mla = lm_vlm_mla("cuda", _build, SEED)
    clock.stamp("26")

    # -- 27. the paper's figures and tables through the port ------------- #
    _free(True)
    figs = figures("cuda", _build)
    clock.stamp("27")

    # -- 28. the last dense architectures at full width ----------------- #
    dense = lm_dense("cuda", _build, SEED)
    clock.stamp("28")

    # -- 29. the kernel and engine microbenchmarks ---------------------- #
    _free(True)
    kb_build.join()
    kbench = kernel_bench("cuda", _build)
    clock.stamp("29")

    # -- 30. results ----------------------------------------------------- #
    def slice5_launches(kernel):
        return {f"launches_{phase}":
                slice5[f"{phase}_launches"].get(kernel, 0)
                for phase in ("fig20", "db", "autotune", "online")}

    def kernel_bench_keys(kernel):
        return {"launches_kernel_bench": kbench["launches"][kernel],
                "kernel_bench_ms": kbench["ms"][kernel],
                "kernel_bench_bound_ms": kbench["bound_ms"][kernel],
                "kernel_bench_bound_by": kbench["bound_by"][kernel]}

    results["kernels"] = [
        {"name": "bit_transpose32", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/bit_transpose.cu",
         "replaces": "src/repro/kernels/bit_transpose.py:46",
         "launches": launches["bit_transpose32"]
         + serve["serve_launches"]["bit_transpose32"]
         + train["train_launches"]["bit_transpose32"]
         + shard["shard_launches"]["bit_transpose32"]
         + sharded["launches"]["bit_transpose32"]
         + subq["launches"]["bit_transpose32"]
         + moe_encdec["launches"]["bit_transpose32"]
         + vlm_mla["launches"]["bit_transpose32"]
         + figs["launches"]["bit_transpose32"]
         + dense["launches"]["bit_transpose32"]
         + kbench["launches"]["bit_transpose32"],
         "launches_main": launches["bit_transpose32"],
         **kernel_bench_keys("bit_transpose32"),
         "launches_figures": figs["launches"]["bit_transpose32"],
         "launches_subquadratic": subq["launches"]["bit_transpose32"],
         "launches_moe_encdec": moe_encdec["launches"]["bit_transpose32"],
         "launches_vlm_mla": vlm_mla["launches"]["bit_transpose32"],
         "launches_dense": dense["launches"]["bit_transpose32"],
         "launches_cells_sharded": sharded["launches"]["bit_transpose32"],
         "launches_shard_words": shard["shard_launches"]["bit_transpose32"],
         "launches_serve": serve["serve_launches"]["bit_transpose32"],
         "launches_train": train["train_launches"]["bit_transpose32"],
         "train_ms": train["train_k1"][0],
         "train_plain_ms": train["train_k1"][1],
         "train_bound_ms": train["train_k1"][2],
         "train_shape": list(train["train_k1"][3]),
         "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bound,
         "bound_by": "bytes", "library_ms": None,
         "serve_ms": serve["serve_k1"][0],
         "serve_plain_ms": serve["serve_k1"][1],
         "serve_bound_ms": serve["serve_k1"][2],
         "launches_controller": ctrl_launches["bit_transpose32"],
         "launches_async": async_launches["bit_transpose32"],
         "launches_capture": capture_launches["bit_transpose32"],
         **slice5_launches("bit_transpose32"),
         "build_s": _build.BUILDS[bit_transpose.build_item()[0]]["seconds"]},
        {"name": "run_program_cuda", "route": "cuda",
         "source": "src/repro_torch/kernels/codegen.py",
         "replaces": "src/repro/kernels/fused_program.py:655",
         "launches": launches["run_program_cuda"]
         + serve["serve_launches"]["run_program_cuda"]
         + train["train_launches"]["run_program_cuda"]
         + shard["shard_launches"]["run_program_cuda"]
         + sharded["launches"]["run_program_cuda"]
         + subq["launches"]["run_program_cuda"]
         + moe_encdec["launches"]["run_program_cuda"]
         + vlm_mla["launches"]["run_program_cuda"]
         + figs["launches"]["run_program_cuda"]
         + dense["launches"]["run_program_cuda"]
         + kbench["launches"]["run_program_cuda"],
         "launches_main": launches["run_program_cuda"],
         "launches_kernel_bench": kbench["launches"]["run_program_cuda"],
         "launches_figures": figs["launches"]["run_program_cuda"],
         "launches_subquadratic": subq["launches"]["run_program_cuda"],
         "launches_moe_encdec": moe_encdec["launches"]["run_program_cuda"],
         "launches_vlm_mla": vlm_mla["launches"]["run_program_cuda"],
         "launches_dense": dense["launches"]["run_program_cuda"],
         "launches_cells_sharded": sharded["launches"]["run_program_cuda"],
         "launches_shard_words": shard["shard_launches"]["run_program_cuda"],
         "launches_serve": serve["serve_launches"]["run_program_cuda"],
         "launches_train": train["train_launches"]["run_program_cuda"],
         "train_ms": train["train_k2"][0],
         "train_plain_ms": train["train_k2"][1],
         "train_bound_ms": train["train_k2"][2],
         "train_shape": list(train["train_k2"][3]),
         "serve_ms": serve["serve_k2"][0],
         "serve_plain_ms": serve["serve_k2"][1],
         "serve_bound_ms": serve["serve_k2"][2],
         "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_bound,
         "bound_by": "bytes" if k2_bound_b >= k2_bound_o else "operations",
         "library_ms": k2_lib, "build_s": k2_build,
         "launches_controller": ctrl_launches["run_program_cuda"],
         "launches_async": async_launches["run_program_cuda"],
         "launches_capture": capture_launches["run_program_cuda"],
         **slice5_launches("run_program_cuda")},
        {"name": "maj_n", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/maj_n.cu",
         "replaces": "src/repro/kernels/maj_n.py:44",
         "launches": rel_launches["maj_n"] + figs["launches"]["maj_n"]
         + kbench["launches"]["maj_n"],
         "launches_figures": figs["launches"]["maj_n"],
         **kernel_bench_keys("maj_n"),
         "max_abs_err": k3_err,
         "ms": k3_ms, "plain_ms": k3_plain, "bound_ms": k3_bound,
         "bound_by": k3_bound_by,
         "library_ms": None, "shape": [k3_n, k3_w],
         "device_us": [{k: r[k] for k in ("shape", "threshold", "geometry",
                                          "us", "bound_us", "share")}
                       for r in k3_recs],
         **{k: k3_floors[k] for k in ("copy_us", "copy_vote_us",
                                       "empty_us")},
         "launches_chip_model": chip_launches["maj_n"],
         "launches_sim": sim_launches["maj_n"],
         "launches_controller_injected": ctrl_inj_launches["maj_n"],
         "launches_autotune_injected":
             slice5["injected_launches"].get("maj_n", 0),
         "build_s": _build.BUILDS[maj_n.build_item()[0]]["seconds"]},
        {"name": "bitserial_add", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/bitserial_add.cu",
         "replaces": "src/repro/kernels/bitserial_add.py:32",
         "launches": chip_launches["bitserial_add"]
         + kbench["launches"]["bitserial_add"],
         "launches_chip_model": chip_launches["bitserial_add"],
         **kernel_bench_keys("bitserial_add"), "max_abs_err": k4_err,
         "ms": k4_times[32][0], "plain_ms": k4_times[32][1],
         "bound_ms": k4_times[32][2], "bound_by": k4_times[32][3],
         "library_ms": None, "shape": [32, 65536],
         "ms_64": k4_times[64][0], "bound_ms_64": k4_times[64][2],
         "build_s": _build.BUILDS[k4.build_item()[0]]["seconds"]},
        {"name": "charge_share", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/charge_share.cu",
         "replaces": "src/repro/kernels/charge_share.py:33",
         "launches": cal_launches["charge_share"]
         + figs["launches"]["charge_share"]
         + kbench["launches"]["charge_share"],
         "launches_figures": figs["launches"]["charge_share"],
         **kernel_bench_keys("charge_share"),
         "max_abs_err": k5_err,
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
