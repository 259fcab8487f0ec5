"""``tools/check_api_torch.py``, the port's API snapshot: it passes on
the current tree with JAX and the reference package unimportable, and it
detects drift from the reference's snapshot in either direction."""

from __future__ import annotations

import importlib.util
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOOL = ROOT / "tools" / "check_api_torch.py"
BLOCK = ("import sys\n"
         "for name in ('jax', 'jaxlib', 'repro'):\n"
         "    sys.modules[name] = None\n"
         "import runpy\n"
         f"sys.argv = [{str(TOOL)!r}]\n"
         f"runpy.run_path({str(TOOL)!r}, run_name='__main__')\n")


def _load():
    spec = importlib.util.spec_from_file_location("check_api_torch", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_port_surface_matches_the_reference_snapshot_without_jax():
    out = subprocess.run([sys.executable, "-c", BLOCK], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ,
                                  PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr
    assert "repro_torch.pum surface OK" in out.stdout


def test_snapshot_detects_drift(monkeypatch, capsys):
    mod = _load()
    monkeypatch.setattr(mod, "EXTRA", {"EngineConfig": ["device"]})
    assert mod.main([]) == 1
    assert "unexpected exports ['torch_device']" in capsys.readouterr().err
    monkeypatch.setattr(mod, "EXTRA", {**mod.EXTRA, "PumArray": ["__matmul__"]})
    monkeypatch.setattr(mod, "RENAMED_BACKENDS", {})
    assert mod.main([]) == 1
    err = capsys.readouterr().err
    assert "missing exports ['__matmul__']" in err
    assert "'pallas-tpu'" in err and "'words-cpu'" in err
