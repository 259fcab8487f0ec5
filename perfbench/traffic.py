"""The one traffic generator: it reads a traffic file's parameters and
makes a cell's inputs from the seed. The same seed gives the same inputs;
token ids are uniform over the configuration's real vocabulary.

* ``token_rows`` (training): each step is ``seqs_per_step`` rows of
  ``seq_len + 1`` tokens (the labels are the rows shifted by one). Every
  step of every seed has other rows.
* ``closed_loop`` (serving): requests with prompt and output lengths from
  ``prompt_tokens`` and ``output_tokens``: block after block of ``block``
  requests, each block holding the same ``block`` (prompt, output) pairs
  (their quantiles) in an order drawn from ``order_seed``. Every seed
  serves the same sizes in the same order, so the same work in the same
  queue; the seed draws the prompts' token ids.
"""

from __future__ import annotations

import numpy as np

SEED_MASK = (1 << 63) - 1


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A generator for one stream of a seed (any whole number, also past
    32 bits)."""
    return np.random.default_rng([int(seed) & SEED_MASK, *stream])


def quantiles(dist: dict, n: int) -> np.ndarray:
    """``n`` evenly spaced quantiles of ``dist`` as whole numbers."""
    u = (np.arange(n) + 0.5) / n
    if dist["dist"] == "uniform":
        lo, hi = dist["lo"], dist["hi"]
        return (lo + np.floor(u * (hi - lo + 1))).astype(np.int64)
    raise ValueError(f"no quantiles for {dist['dist']!r}")


def train_rows(traffic: dict, vocab: int, seed: int, step: int) -> np.ndarray:
    """Step ``step``'s rows: int64 ``[seqs_per_step, seq_len + 1]``."""
    g = rng(seed, 1, step)
    return g.integers(0, vocab, (traffic["seqs_per_step"],
                                 traffic["seq_len"] + 1), dtype=np.int64)


def serve_requests(traffic: dict, vocab: int, seed: int) -> list[dict]:
    """The request stream of a closed loop: ``blocks`` blocks of
    ``block`` requests, each a dict of ``prompt`` (int32 ids) and
    ``max_new_tokens``."""
    n = traffic["block"]
    prompts = quantiles(traffic["prompt_tokens"], n)
    # A fixed pairing of prompt and output quantiles, the same for every
    # seed: output quantile (7 i mod n), n odd to 7.
    outs = quantiles(traffic["output_tokens"], n)[(7 * np.arange(n)) % n]
    order, g = rng(traffic["order_seed"], 2), rng(seed, 2)
    out = []
    for _ in range(traffic["blocks"]):
        for i in order.permutation(n):
            out.append({"prompt": g.integers(0, vocab, int(prompts[i]),
                                             dtype=np.int64).astype(np.int32),
                        "max_new_tokens": int(outs[i])})
    return out
