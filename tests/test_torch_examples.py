"""The port's examples against the reference's ``examples/*.py``.

Each test runs the reference example and the port's
(``repro_torch.examples.*`` with ``--device cpu``) in this process and
compares what they print, line for line: the command-level latencies,
sequence and row counts, correctness flags and success rates of
``quickstart`` and ``coldboot_defense`` are equal; ``serve_llm`` serves
the same smoke weights (the reference's draw, carried over by
``convert.params_from_reference``), so its request and token counts and
every printed token stream are equal, and only its wall time, tok/s and
TTFT line are left out. ``serve_llm`` runs its smoke config in float32
in both packages here: in bfloat16 the two round at other places, and a
greedy pick at a near tie flips (mamba2-130m's smoke stream, request 1,
fourth token, with the per-token prefill state as with the closed form).
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import io
import pathlib
import sys

import jax
import numpy as np
import pytest

from repro.config import base as rbase
from repro.models import model as rmodel
from repro_torch.convert import params_from_reference
from repro_torch.examples import coldboot_defense, quickstart, serve_llm
from repro_torch.serve import engine as tengine

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _reference_example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _printed(fn, *args) -> list[str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue().splitlines()


@pytest.mark.parametrize("name,port", [("quickstart", quickstart),
                                       ("coldboot_defense",
                                        coldboot_defense)])
def test_chip_examples_print_the_reference_lines(name, port):
    want = _printed(_reference_example(name).main)
    got = _printed(port.main, ["--device", "cpu"])
    assert len(want) >= 5 and got == want


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mamba2-130m",
                                  "hymba-1.5b"])
def test_serve_llm_prints_the_reference_tokens(arch, monkeypatch):
    def carried(cfg, seed, device):
        rp = rmodel.init_params(rbase.get_smoke_config(arch),
                                jax.random.PRNGKey(seed))
        return params_from_reference(cfg, jax.tree.map(np.asarray, rp),
                                     device=device)

    def float32(get):
        return lambda name: dataclasses.replace(get(name), dtype="float32")

    monkeypatch.setattr(tengine, "init_params", carried)
    monkeypatch.setattr(serve_llm, "get_smoke_config",
                        float32(serve_llm.get_smoke_config))
    reference = _reference_example("serve_llm")
    reference.get_smoke_config = float32(reference.get_smoke_config)
    argv = ["--arch", arch, "--requests", "5", "--max-new", "6"]
    monkeypatch.setattr(sys, "argv", ["serve_llm.py"] + argv)
    want = _printed(reference.main)
    got = _printed(serve_llm.main, argv + ["--device", "cpu"])
    assert len(got) == len(want) == 5
    # "5 requests, 30 tokens in <wall>s (<tok/s> tok/s aggregate)"
    assert got[0].split(" in ")[0] == want[0].split(" in ")[0] \
        == "5 requests, 30 tokens"
    assert got[1].startswith("TTFT: mean ")
    assert got[2:] == want[2:]
