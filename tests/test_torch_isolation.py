"""The port stands alone: no module of ``src/repro_torch`` (and not
``chip_smoke.py``) imports JAX or the reference package, and the port's
public API imports, flushes, calibrates and runs an injected flush with
both of them unimportable — and so do the chip model (``PulsarChip``,
the executor, the bit-serial ALU, cold-boot destruction), the ``sim``
backend, the bit-serial add kernel's dispatch, the controller
(``repro_torch.controller``, a controller-priced flush), named clients,
``flush_async`` and a captured program — and so do the Fig 20 app
kernels (``repro_torch.core.realworld``, the ``pum_database`` example),
the autotuner and ``Device.autotune``, offline and online."""

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
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    bad = [(str(p.relative_to(ROOT)), m) for p in files for m in _imports(p)
           if m.split(".")[0] in FORBIDDEN]
    assert bad == []


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
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ,
                                  PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
