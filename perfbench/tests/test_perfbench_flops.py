"""The frozen FLOP count against figures worked out by hand."""

import pytest

from perfbench import flops, spec


def _arch(name):
    return spec.arch(spec.load_json(spec.HERE / "configs" / f"{name}.json"))


def test_train_4k_step():
    a = _arch("qwen3-1.7b")
    # 6 x (1.409e9 layer weights + 0.311e9 head) x 16,384 tokens
    # + 3 x 4 rows x 28 layers x 2 T^2 H dh at T = 4,096
    want = 6 * 1.720e9 * 16384 + 3 * 4 * 28 * 2 * 4096 ** 2 * 2048
    assert flops.train_step(a, 4, 4096) == pytest.approx(1.92e14, rel=2e-3)
    assert flops.train_step(a, 4, 4096) == pytest.approx(want, rel=1e-3)


def test_qwen25_32b_prompt_token():
    a = _arch("qwen2.5-32b")
    assert flops.non_embedding(a) == pytest.approx(31.2e9, rel=1e-3)
    t = 2048
    assert flops.prefill(a, t) == pytest.approx(
        2 * flops.non_embedding(a) * t + 64 * 2 * t * t * 40 * 128
        + 2 * 5120 * 152064, rel=1e-12)


def test_decode_token_attends_to_its_context():
    a = _arch("qwen2.5-32b")
    d = flops.decode_token(a, 100) - flops.decode_token(a, 99)
    assert d == 64 * 2 * 2 * 40 * 128


def test_peak():
    assert flops.PEAK_BF16_FLOPS == 989.4e12
