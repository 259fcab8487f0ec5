"""The plain reference against the port at smoke size on the CPU, in
float32: forward logits, prefill then decode through the cache, and the
training steps (losses, first gradients, the first update, changes)."""


import pytest
import torch

from perfbench import spec, weights
from perfbench.drivers import train
from perfbench.reference import dense as ref
from perfbench.tests.smoke import small_cell

CELLS = {"qwen3-1.7b": "qwen3-1.7b.train-4k",
         "qwen2.5-32b": "qwen2.5-32b.serve-doc"}


def _model(name, seed=3):
    cell = small_cell(CELLS[name])
    conf = cell["config"]
    cfg = spec.port_config(conf, name, dtype="float32", remat="none")
    params = weights.make(conf, weights.shapes(cfg), seed, "cpu")
    return conf, cfg, params


@pytest.mark.parametrize("name", sorted(CELLS))
def test_forward_logits(name):
    from repro_torch.models.model import forward
    conf, cfg, params = _model(name)
    a = spec.arch(conf)
    ids = torch.randint(0, a["vocab"], (23,),
                        generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got, _ = forward(cfg, params, {"tokens": ids[None]})
    want = ref.logits_at(a, params, [ids], [torch.arange(23)])[0]
    torch.testing.assert_close(got[0, :, :a["vocab"]], want, rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("name", sorted(CELLS))
def test_prefill_then_decode(name):
    from repro_torch.models.model import decode_step, prefill
    conf, cfg, params = _model(name)
    a = spec.arch(conf)
    ids = torch.randint(0, a["vocab"], (17,),
                        generator=torch.Generator().manual_seed(2))
    got = []
    with torch.no_grad():
        logits, caches, _ = prefill(cfg, params, {"tokens": ids[None, :12]},
                                    32)
        got.append(logits[0])
        for p in range(12, 17):
            logits, caches = decode_step(cfg, params, caches, ids[p:p + 1],
                                         torch.tensor([p]))
            got.append(logits[0])
    got = torch.stack(got)[:, :a["vocab"]]
    want = ref.logits_at(a, params, [ids], [torch.arange(11, 17)])[0]
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("rows", [slice(None), slice(0, 2)])
def test_training_steps(rows):
    cell = small_cell("qwen3-1.7b.train-4k")
    cell["workload"]["train"].update(dtype="float32", microbatches=2)
    fault = None
    if rows != slice(None):
        def fault(step):
            return lambda p, o, b: step(p, o, {"tokens": b["tokens"][rows]})
    state, prog, _ = train.program(cell, 5, "cpu", fault)
    r = train.reference(cell, 5, "cpu", rows=rows)
    values = train.compare(prog, r)["values"]
    assert values["loss_gap"] < 1e-6
    assert values["grad_gap"] < 1e-4
    assert values["grad_dist"] < 1e-4
    assert values["change_gap"] < 1e-4
    assert train.update_check(cell, 5, prog, "cpu")[0] < 1e-5


def test_fp8_control_rounds_inputs():
    x = torch.linspace(-3, 3, 101)
    y = ref.fp8(x)
    assert torch.all((y - x).abs() <= x.abs() / 16 + 1e-6)
    assert not torch.equal(x, y)
    torch.testing.assert_close(ref.mm(x[None], x[:, None], "fp32"),
                               (x @ x)[None, None])


def test_lr_scale_matches_the_port():
    from repro_torch.train.optimizer import warmup_cosine
    for warmup in (0, 2000):
        for s in (0, 1, 5, 2000, 2500, 100000):
            assert ref.lr_scale(s, warmup, 100000) == pytest.approx(
                float(warmup_cosine(torch.tensor(s), warmup, 100000)),
                rel=1e-6)
