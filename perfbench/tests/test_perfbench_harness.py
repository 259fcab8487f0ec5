"""A whole run at smoke size on the CPU, past the harness's look for a
card: a sound run comes out correct, and a run with the timed path
broken underneath comes out not correct (a step that returns its state
unchanged; half of each batch left out; AdamW without weight decay or
with another beta2; a served token altered where it is produced; a stop
mask flipped). The control, the reference in float8
put in the program's place, reads far above the program."""

import copy
import io
import json
import os
import pathlib
import shutil
import subprocess
import sys
import time

import pytest
import torch

from perfbench import checks
from perfbench.drivers import serve, train
from perfbench.tests.smoke import small_cell

ROOT = pathlib.Path(__file__).resolve().parents[2]
SEED = 2 ** 40 + 17
# Smoke-size limits between the readings of sound runs and of faults
# here (the cells' own limits are set at full size, PERF.md).
TRAIN_LIMITS = {"loss_gap": 1e-3, "grad_gap": 0.02, "grad_dist": 0.05,
                "change_gap": 0.02, "update_gap": 1e-4}
SERVE_LIMITS = {"logit_gap": 0.05, "stop_mismatches": 0}


def _train(fault=None, optimizer=None):
    cell = small_cell("qwen3-1.7b.train-4k")
    cell["workload"]["limits"] = TRAIN_LIMITS
    if optimizer:
        # The program runs with another setting than the cell states.
        real = train.program

        def planted(c, *args):
            c = copy.deepcopy(c)
            c["workload"]["train"]["optimizer"].update(optimizer)
            return real(c, *args)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(train, "program", planted)
            return train.run(cell, SEED, 0.3, False, "cpu",
                             time.perf_counter())
    return train.run(cell, SEED, 0.3, False, "cpu", time.perf_counter(),
                     fault=fault)


def _serve(fault=None, trace=False):
    cell = small_cell("qwen2.5-32b.serve-doc")
    cell["workload"]["engine"]["dtype"] = "bfloat16"
    cell["workload"]["limits"] = SERVE_LIMITS
    return serve.run(cell, SEED, 0.5, trace, "cpu", time.perf_counter(),
                     fault=fault)


def test_train_sound_run_is_correct():
    rec = _train()
    assert checks.passed(rec["checks"]), rec["checks"]
    assert rec["steps"] >= 1 and rec["tokens"] == rec["steps"] * 128


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.detach().clone().requires_grad_(tree.requires_grad)


def test_train_state_left_unchanged_fails():
    def fault(step):
        def unchanged(p, o, b):
            _, _, metrics = step(_clone(p), _clone(o), b)
            return p, o, metrics
        return unchanged
    rec = _train(fault)
    assert not checks.passed(rec["checks"])
    assert rec["checks"]["change_gap"]["value"] == pytest.approx(1.0)
    assert rec["checks"]["grad_gap"]["value"] == pytest.approx(1.0)
    assert rec["checks"]["grad_dist"]["value"] == pytest.approx(1.0)
    assert rec["checks"]["update_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("optimizer", [{"weight_decay": 0.0},
                                       {"beta2": 0.999}])
def test_train_wrong_adamw_update_fails(optimizer):
    rec = _train(optimizer=optimizer)
    assert rec["checks"]["update_gap"]["value"] > 10 * TRAIN_LIMITS[
        "update_gap"]
    assert not checks.passed(rec["checks"])


def test_train_half_batch_fails():
    def fault(step):
        return lambda p, o, b: step(p, o, {"tokens": b["tokens"][:2]})
    rec = _train(fault)
    assert not checks.passed(rec["checks"])


def test_serve_sound_run_is_correct():
    rec = _serve()
    assert checks.passed(rec["checks"]), rec["checks"]
    assert rec["attempted"] > 0 and rec["ttft_s"]


def test_serve_altered_token_fails():
    def fault(engine):
        inner = engine._decode_tokens

        def altered():
            toks = inner()
            return (toks + 1) % engine.cfg.vocab_size
        engine._decode_tokens = altered
    rec = _serve(fault)
    assert rec["checks"]["logit_gap"]["value"] > SERVE_LIMITS["logit_gap"]
    assert not checks.passed(rec["checks"])


def test_serve_flipped_stop_mask_fails():
    def fault(engine):
        inner = engine._stop_mask_pum
        calls = [0]

        def flipped(active):
            out = inner(active)
            calls[0] += 1
            if calls[0] % 3 == 0 and out:
                out[0] = not out[0]
            return out
        engine._stop_mask_pum = flipped
    rec = _serve(fault)
    assert rec["checks"]["stop_mismatches"]["value"] > 0
    assert not checks.passed(rec["checks"])


def test_control_reads_above_the_program():
    from perfbench import control
    out = io.StringIO()
    control.train_readings(small_cell("qwen3-1.7b.train-4k"), 11, "cpu",
                           True, out)
    rows = {r["what"]: r["values"] for r in map(json.loads, out.getvalue()
                                                 .splitlines())
            if "values" in r}
    prog, low = rows["program"], rows["control_fp8"]
    assert low["loss_gap"] > 3 * prog["loss_gap"]
    assert low["grad_dist"] > 3 * prog["grad_dist"]
    assert rows["fault_half_batch"]["grad_gap"] > 3 * prog["grad_gap"]
    upd = {r["what"]: r["update_gap"] for r in map(
        json.loads, out.getvalue().splitlines()) if "update_gap" in r}
    assert upd["program"] < TRAIN_LIMITS["update_gap"]
    assert upd["fault_no_weight_decay"] > 10 * TRAIN_LIMITS["update_gap"]
    assert upd["fault_beta2"] > 10 * TRAIN_LIMITS["update_gap"]


def test_run_refuses_without_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, str(ROOT / "perfbench" / "run.py"),
                        "--workload", "qwen3-1.7b.train-4k", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=300)
    assert p.returncode != 0 and '"correct"' not in p.stdout


def test_run_refuses_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "qwen3-1.7b.train-4k", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], capture_output=True,
                       text=True, cwd=tmp_path, timeout=300,
                       env={k: v for k, v in os.environ.items()
                            if k != "PYTHONPATH"})
    assert p.returncode != 0 and '"correct"' not in p.stdout


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the cells run only on the card)")
    return "cuda"


@pytest.mark.cuda
def test_train_sound_run_on_the_card(card):
    cell = small_cell("qwen3-1.7b.train-4k")
    cell["workload"]["limits"] = TRAIN_LIMITS
    rec = train.run(cell, SEED, 0.3, True, card, time.perf_counter())
    assert checks.passed(rec["checks"]), rec["checks"]
    assert rec["trace"]["busy_s"] > 0
