"""The traffic generator: the same seed gives the same inputs, other
seeds and steps other rows, and every serving seed the same sizes in the
same order, with other token ids."""

import collections

import numpy as np
import pytest

from perfbench import spec, traffic

BIG = 2 ** 62 + 12345


def _mix(name):
    return spec.load_json(spec.HERE / "traffic" / f"{name}.json")


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5, BIG])
def test_train_rows_repeat_per_seed(seed):
    t = _mix("train-4k")
    a = traffic.train_rows(t, 151936, seed, 3)
    assert a.shape == (4, 4097) and a.dtype == np.int64
    assert np.array_equal(a, traffic.train_rows(t, 151936, seed, 3))
    assert a.min() >= 0 and a.max() < 151936


def test_train_rows_differ_between_steps_and_seeds():
    t = _mix("train-4k")
    rows = [traffic.train_rows(t, 151936, 1, s) for s in range(3)]
    rows.append(traffic.train_rows(t, 151936, 2, 0))
    flat = {r.tobytes() for batch in rows for r in batch}
    assert len(flat) == 16


def test_train_rows_cover_the_vocabulary():
    t = _mix("train-4k")
    ids = np.concatenate([traffic.train_rows(t, 151936, 9, s).ravel()
                          for s in range(4)])
    # 65,552 draws, uniform over the vocabulary: no id is special
    assert ids.min() < 1000 and ids.max() > 150936
    assert np.bincount(ids, minlength=151936).max() <= 8


@pytest.mark.parametrize("seed", [3, BIG])
def test_serve_requests_repeat_per_seed(seed):
    t = _mix("serve-doc")
    a = traffic.serve_requests(t, 152064, seed)
    b = traffic.serve_requests(t, 152064, seed)
    assert len(a) == t["block"] * t["blocks"]
    assert all(np.array_equal(x["prompt"], y["prompt"])
               and x["max_new_tokens"] == y["max_new_tokens"]
               for x, y in zip(a, b))


def test_serve_blocks_hold_the_same_sizes_for_every_seed():
    t = _mix("serve-doc")
    n = t["block"]

    def sizes(seed):
        return [(len(r["prompt"]), r["max_new_tokens"])
                for r in traffic.serve_requests(t, 152064, seed)]

    a, b = sizes(1), sizes(BIG)
    # one fixed order for every seed: the same work in the same queue
    assert a == b
    blocks = [collections.Counter(a[i:i + n]) for i in range(0, len(a), n)]
    assert all(x == blocks[0] for x in blocks)
    assert a[:n] != a[n:2 * n]
    assert min(p for p, _ in a) >= 1024 and max(p for p, _ in a) <= 3072
    assert {o for _, o in a} <= set(range(4, 25))


def test_serve_token_ids_differ_between_seeds():
    t = _mix("serve-doc")
    a = traffic.serve_requests(t, 152064, 1)
    b = traffic.serve_requests(t, 152064, 2)
    assert not any(np.array_equal(x["prompt"], y["prompt"])
                   for x, y in zip(a, b))
    assert all(0 <= x["prompt"].min() and x["prompt"].max() < 152064
               for x in a)


def test_quantiles_cover_the_range():
    q = traffic.quantiles({"dist": "uniform", "lo": 4, "hi": 24}, 21)
    assert list(q) == list(range(4, 25))
