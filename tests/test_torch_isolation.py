"""The port stands alone: no module of ``src/repro_torch`` (and not
``chip_smoke.py``) imports JAX or the reference package, and the port's
public API imports, flushes, calibrates and runs an injected flush with
both of them unimportable — and so do the chip model (``PulsarChip``,
the executor, the bit-serial ALU, cold-boot destruction), the ``sim``
backend, the bit-serial add kernel's dispatch, the controller
(``repro_torch.controller``, a controller-priced flush), named clients,
``flush_async`` and a captured program — and so do the Fig 20 app
kernels (``repro_torch.core.realworld``, the ``pum_database`` example),
the autotuner and ``Device.autotune``, offline and online — and so does
the LM serve path: the configs, the models of every family, the
``ServeEngine`` with its captured stop predicate, and the launcher —
and so does the LM train path: the optimizer, both gradient
compressions, the trainer, the data pipeline, checkpoints, fault
tolerance, the train launcher and the ``train_lm`` example — and so does the launch
and distributed slice: a ``shard-words`` flush, the meshes and sharding
rules, a cell built and traced by the analytic dry run, the roofline and
its table, and the ``hypothesis`` fallback — and so do the SSM prefill
state's closed form, the ``quickstart``, ``coldboot_defense`` and
``serve_llm`` examples; ``tools/check_api_torch.py`` imports neither
(``tests/test_torch_check_api.py`` runs it with both unimportable), nor
do ``tools/hymba_prefill_repro.py`` and ``tools/cells_fit.py``."""

from __future__ import annotations

import ast
import os
import pathlib
import subprocess
import sys
import textwrap

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imports(path: pathlib.Path) -> list[str]:
    mods = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            mods.extend(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            mods.append("." if node.level else node.module or "")
    return mods


def test_no_jax_or_reference_imports():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    tools = [ROOT / "chip_smoke.py", ROOT / "tools" / "check_api_torch.py",
             ROOT / "tools" / "hymba_prefill_repro.py",
             ROOT / "tools" / "cells_fit.py"]
    assert len(files) > 10
    packages = {p.relative_to(ROOT / "src" / "repro_torch").parts[0]
                for p in files}
    files += tools
    assert {"config", "configs", "models", "serve", "launch",
            "distributed", "train", "data", "checkpoint"} <= packages
    names = {p.relative_to(ROOT).as_posix() for p in files}
    assert {"src/repro_torch/launch/train.py",
            "src/repro_torch/distributed/fault_tolerance.py",
            "src/repro_torch/examples/train_lm.py",
            "src/repro_torch/launch/mesh.py",
            "src/repro_torch/launch/steps.py",
            "src/repro_torch/launch/roofline.py",
            "src/repro_torch/launch/dryrun.py",
            "src/repro_torch/launch/dryrun_table.py",
            "src/repro_torch/distributed/sharding.py",
            "src/repro_torch/testing.py",
            "src/repro_torch/examples/quickstart.py",
            "src/repro_torch/examples/coldboot_defense.py",
            "src/repro_torch/examples/serve_llm.py",
            "tools/check_api_torch.py",
            "tools/hymba_prefill_repro.py",
            "tools/cells_fit.py"} <= names
    bad = [(str(p.relative_to(ROOT)), m) for p in files for m in _imports(p)
           if m.split(".")[0] in FORBIDDEN]
    assert bad == []
    # The paper's figures through the port: no JAX, no reference package,
    # and of ``benchmarks`` only ``common`` and the port's own modules.
    figures = sorted((ROOT / "benchmarks").glob("torch_*.py"))
    assert {p.name for p in figures} >= {
        "torch_run.py", "torch_fig04_process_variation.py",
        "torch_reliability_sweep.py"}
    bad = [(p.name, m) for p in figures for m in _imports(p)
           if m.split(".")[0] in FORBIDDEN or m == "."
           or (m.split(".")[0] == "benchmarks"
               and m not in ("benchmarks", "benchmarks.common")
               and not m.startswith("benchmarks.torch_"))]
    assert bad == []
    # ``from benchmarks import X`` names only ``common`` or a port module.
    for p in figures:
        for node in ast.walk(ast.parse(p.read_text(), str(p))):
            if (isinstance(node, ast.ImportFrom)
                    and node.module == "benchmarks"):
                assert all(a.name == "common" or a.name.startswith("torch_")
                           for a in node.names), (p.name, ast.dump(node))


def test_port_runs_with_jax_and_reference_unimportable():
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "repro"):
            sys.modules[name] = None  # any import of them now fails
        import numpy as np
        import repro_torch.pum as pum
        with pum.device(width=16, device="cpu") as dev:
            x = dev.asarray(np.arange(64, dtype=np.uint64))
            y = (x * 3 + 1) // 2
        assert y.to_numpy().tolist() == [(3 * i + 1) // 2 for i in range(64)]
        assert dev.stats.latency_ns > 0
        # The analog and reliability slice: calibrate, then an injected
        # flush voted back to the clean values.
        dev = pum.device(width=16, banks=2, device="cpu")
        dev.calibrate(inject=True, n_subarrays=2, n_columns=32,
                      n_patterns=4, flip_scale=1e6, steer=False)
        x = dev.asarray(np.arange(64, dtype=np.uint64))
        z = (x + 5).to_numpy()
        assert z.tolist() == [i + 5 for i in range(64)]
        assert dev.counters.get("reliability.flushes") == 1
        # The chip-model slice: the sim backend, the chip, the ALU, the
        # destruction use case and the bit-serial add dispatch.
        import torch
        from repro_torch.core import (BitSerialAlu, PulsarChip,
                                      PulsarExecutor, TEST_GEOMETRY, MFR_H)
        from repro_torch.core.destruction import destroy_bank_rowclone
        from repro_torch.kernels import bitserial_add
        sim = pum.device(mfr="H", width=8, backend="sim", row_bits=64,
                         device="cpu")
        a = np.arange(64, dtype=np.uint64)
        assert (sim.asarray(a) * 3).to_numpy().tolist() == [
            (3 * i) % 256 for i in range(64)]
        chip = PulsarChip(TEST_GEOMETRY, MFR_H, device="cpu")
        alu = BitSerialAlu(PulsarExecutor(chip, 0, 0), width=4)
        v = alu.load(np.arange(1024, dtype=np.uint64) % 16)
        s = alu.store(alu.add(v, v))
        assert s.tolist() == [(2 * i) % 16 for i in range(1024)]
        assert destroy_bank_rowclone(chip, 1).rows_destroyed == 128
        p = torch.stack([chip.peek(0, r) for r in v.pos_rows])
        assert torch.equal(bitserial_add(p, p)[1:], p[:-1])
        # The controller and concurrency slice: a controller-priced
        # flush, the crossbar, a named client's flush_async and a capture.
        from repro_torch.controller import Crossbar, MemoryController
        from repro_torch.telemetry import check_timing_invariants
        cdev = pum.device(width=16, controller="auto", device="cpu")
        assert isinstance(cdev.engine.controller, MemoryController)
        x = cdev.asarray(np.arange(64, dtype=np.uint64))
        assert ((x + 1) * x).to_numpy().tolist() == [
            ((i + 1) * i) % 65536 for i in range(64)]
        assert cdev.stats.refresh_stall_ns > 0
        xb = Crossbar(n_ports=2, refresh=False)
        xb.port(0).submit_access(0, row=1)
        xb.port(1).submit_access(1, row=2)
        assert check_timing_invariants(xb.run()) == []
        with cdev.client("a"):
            y = cdev.asarray(np.arange(64, dtype=np.uint64)) ^ 5
            cdev.flush_async().result()
        assert y.to_numpy().tolist() == [i ^ 5 for i in range(64)]
        prog = cdev.capture(lambda u, v: u + v)
        assert prog(a, a).tolist() == [2 * i for i in range(64)]
        assert prog(a, a).tolist() == [2 * i for i in range(64)]
        assert prog.n_records == 1 and prog.n_replays == 1
        cdev.close()
        # The app-kernel and autotune slice: the Fig 20 kernels, the
        # example, Device.autotune offline and online.
        from repro_torch.core import realworld
        from repro_torch.autotune import Tuner, WorkloadProfile
        from repro_torch.examples import pum_database
        from repro_torch.telemetry import Tracer
        bm = np.arange(3 * 16, dtype=np.uint64).reshape(3, 16) * 977
        adev = pum.device(device="cpu")
        got, ms, _ = realworld.bmi_active_users(adev, bm)
        assert ms > 0
        adj = np.triu(np.ones((12, 12), np.uint8), 1)
        assert realworld.kclique_star(adev, adj + adj.T,
                                      [(0, 1, 2)])[0] == 9
        import contextlib, io
        with contextlib.redirect_stdout(io.StringIO()):
            out = pum_database.main(device="cpu", n_users=64 * 64, days=3,
                                    n_rows=1024, n_vertices=12)
        assert out["triangle_count"][0] >= 0
        with pum.profile(adev):
            x = adev.asarray(np.arange(256, dtype=np.uint64))
            ((x + 3) * x).to_numpy()
        plan = adev.autotune()
        assert isinstance(plan, pum.TunedPlan)
        assert plan.fused_backend.startswith("words-torch")
        assert isinstance(Tuner().tune(WorkloadProfile.from_device(adev),
                                       adev.config), pum.TunedPlan)
        adev.engine.tracer = Tracer()
        adev.autotune(online=True, window_flushes=1)
        for i in range(3):
            assert (adev.asarray(x.to_numpy()) + i).to_numpy()[1] == 1 + i
        assert adev.engine.autotuner.windows == 3
        # The LM serve path: configs, every model family, the engine
        # with its captured stop predicate, and the launcher.
        from repro_torch.config.base import (ARCH_IDS, get_config,
                                             get_smoke_config)
        from repro_torch.distributed.constraints import maybe_shard
        from repro_torch.launch import serve as launch_serve
        from repro_torch.models import model as lm
        from repro_torch.serve.engine import Request, ServeEngine
        assert get_config("qwen1.5-0.5b").param_count() == 622978048
        for arch in ("mamba2-130m", "deepseek-v2-236b", "hymba-1.5b"):
            cfg = get_smoke_config(arch)
            params = lm.init_params(cfg, 0, device="cpu")
            toks = torch.zeros((1, 8), dtype=torch.long)
            logits, _ = lm.forward(cfg, params, {"tokens": toks})
            assert maybe_shard(logits).shape == (1, 8, cfg.padded_vocab)
        eng = ServeEngine(get_smoke_config("qwen1.5-0.5b"), max_batch=2,
                          max_len=32, eos_id=-1, device="cpu")
        for rid in range(3):
            eng.submit(Request(rid=rid, prompt=np.arange(5, dtype=np.int32),
                               max_new_tokens=3))
        assert [len(r.out_tokens) for r in eng.run_until_drained()] == [3] * 3
        assert eng._stop_prog.n_records == 1
        with contextlib.redirect_stdout(io.StringIO()):
            assert launch_serve.main(["--arch", "qwen3-1.7b", "--smoke",
                                      "--requests", "2", "--max-new", "2",
                                      "--device", "cpu"]) == 0
        # The LM train path: the trainer with both compressions, the
        # data pipeline, a checkpoint round trip, fault tolerance, the
        # launcher and the example.
        import tempfile
        from repro_torch.checkpoint.manager import CheckpointManager
        from repro_torch.config.base import TrainConfig
        from repro_torch.data.pipeline import (DataConfig, Prefetcher,
                                               SyntheticLM)
        from repro_torch.distributed.fault_tolerance import (
            HeartbeatMonitor, plan_elastic_mesh)
        from repro_torch.examples import train_lm
        from repro_torch.launch import train as launch_train
        from repro_torch.train import grad_compress
        from repro_torch.train.trainer import train_loop
        cfg = get_smoke_config("mamba2-130m")
        data = Prefetcher(SyntheticLM(DataConfig(
            seq_len=16, global_batch=2, vocab_size=cfg.vocab_size)))
        with tempfile.TemporaryDirectory() as d:
            ckpt = CheckpointManager(d)
            params, opt, hist = train_loop(
                cfg, TrainConfig(grad_compression=True, checkpoint_every=2),
                data, 3, checkpoint=ckpt, device="cpu")
            data.close()
            assert len(hist) == 3 and ckpt.all_steps() == [2, 3]
            p2, o2, meta = ckpt.restore(3, params, opt)
            assert meta["step"] == 3 and torch.equal(o2["err"]["embed"][
                "embedding"], opt["err"]["embed"]["embedding"])
        deq, err = grad_compress.compress_grads_sign_with_feedback(
            {"g": torch.linspace(-1, 1, 100)}, {"g": torch.zeros(100)},
            device=pum.device(width=32, device="cpu"))
        mag = deq["g"].abs().unique()
        assert len(mag) == 2 and mag[0] == 0 and torch.equal(
            deq["g"] + err["g"], torch.linspace(-1, 1, 100))
        mon = HeartbeatMonitor()
        mon.beat("w0", 0.1)
        assert mon.dead_workers() == [] and plan_elastic_mesh(8, 2) == (4, 2)
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            assert launch_train.main(["--arch", "qwen1.5-0.5b", "--smoke",
                                      "--steps", "2", "--seq-len", "16",
                                      "--global-batch", "2",
                                      "--device", "cpu"]) == 0
            hist = train_lm.main(["--steps", "1", "--seq-len", "16",
                                  "--batch", "2", "--device", "cpu"])
        assert "over 2 steps" in buf.getvalue() and len(hist) == 1
        # The launch and distributed slice: shard-words, meshes, sharding
        # rules, the analytic dry run, the roofline, the test fallback.
        from repro_torch.distributed.sharding import P, words_mesh
        from repro_torch.kernels.fused_program import (
            build_sharded_words_pipeline)
        from repro_torch.launch import dryrun, dryrun_table, roofline
        from repro_torch.launch.mesh import make_test_mesh
        from repro_torch.launch.steps import build_cell
        from repro_torch.testing import given, st
        sdev = pum.device(width=32, fused_backend="shard-words",
                          device="cpu")
        x = sdev.asarray(np.arange(100, dtype=np.uint64))
        assert (x * x).to_numpy().tolist() == [i * i for i in range(100)]
        rec = dryrun.run_cell("mamba2-130m", "decode_32k", False)
        assert rec["flops"] > 0 and (rec["collectives"] is None) == (
            "collectives_error" in rec)
        assert roofline.analyze_record(rec).memory_s > 0
        from repro_torch.config.base import LM_SHAPES
        cell = build_cell("qwen1.5-0.5b", LM_SHAPES["decode_32k"],
                          make_test_mesh(devices=["cpu"]))
        assert cell.in_shardings[0]["embed"]["embedding"].spec == P()
        seen = []
        given(a=st.integers(0, 9))(lambda a: seen.append(a))()
        assert len(seen) == 10
        # The SSM prefill state in closed form; the remaining examples.
        from repro_torch.models import ssm as ssm_mod
        from repro_torch.examples import (coldboot_defense, quickstart,
                                          serve_llm)
        g = torch.Generator().manual_seed(0)
        xs, dts = torch.randn(1, 9, 2, 3, generator=g), torch.rand(1, 9, 2)
        bs, s0 = torch.randn(1, 9, 4, generator=g), torch.ones(1, 2, 4, 3)
        assert torch.allclose(
            ssm_mod.final_state(xs, dts, torch.zeros(2), bs, s0),
            ssm_mod.final_state_naive(xs, dts, torch.zeros(2), bs, s0),
            atol=1e-5)
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            quickstart.main(["--device", "cpu"])
            coldboot_defense.main(["--device", "cpu"])
            done = serve_llm.main(["--arch", "mamba2-130m", "--requests",
                                   "2", "--max-new", "2", "--device", "cpu"])
        text = buf.getvalue()
        assert "correct=False" not in text and text.count("correct=True") == 3
        assert text.count("verified_wiped=True") == 3
        assert [len(r.out_tokens) for r in done] == [2, 2]
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, OMP_NUM_THREADS="1",
                                  PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
