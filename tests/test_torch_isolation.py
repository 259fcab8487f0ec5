"""The port stands alone: no module of ``src/repro_torch`` (and not
``chip_smoke.py``) imports JAX or the reference package, and the port's
public API imports, flushes, calibrates and runs an injected flush with
both of them unimportable."""

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
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ,
                                  PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
