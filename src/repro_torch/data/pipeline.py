"""Data pipeline: deterministic synthetic corpus + memmap-backed token
streams, shard-aware sampling, background prefetch.

The port's copy of ``repro.data.pipeline`` (NumPy only). The loader yields
GLOBAL batches as host NumPy; the trainer copies them onto its device
through pinned memory (``repro_torch.train.trainer.device_batch``).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int = 256
    global_batch: int = 8
    vocab_size: int = 512
    seed: int = 0
    kind: str = "synthetic-lm"   # synthetic-lm | memmap


class SyntheticLM:
    """Deterministic pseudo-corpus with learnable n-gram structure (so a
    training run shows a falling loss, not noise)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # Markov chain with sparse transitions -> learnable structure.
        self._next = rng.integers(0, v, size=(v, 4))

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed * 1_000_003 + step)
        b, t = cfg.global_batch, cfg.seq_len
        toks = np.empty((b, t + 1), np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab_size, b)
        choices = rng.integers(0, 4, size=(b, t))
        for i in range(t):
            toks[:, i + 1] = self._next[toks[:, i], choices[:, i]]
        return {"tokens": toks}


class MemmapTokens:
    """Pre-tokenized flat corpus on disk; shard-aware strided sampling."""

    def __init__(self, path: str, cfg: DataConfig, shard: int = 0,
                 n_shards: int = 1):
        self.tokens = np.memmap(path, dtype=np.int32, mode="r")
        self.cfg = cfg
        self.shard = shard
        self.n_shards = n_shards

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        b, t = cfg.global_batch, cfg.seq_len
        n_windows = (len(self.tokens) - 1) // (t + 1)
        rng = np.random.default_rng(cfg.seed * 7919 + step)
        idx = rng.integers(0, n_windows, b)
        idx = idx[idx % self.n_shards == self.shard % self.n_shards] if \
            self.n_shards > 1 else idx
        while len(idx) < b:
            idx = np.concatenate([idx, idx])[:b]
        out = np.stack([self.tokens[i * (t + 1):(i + 1) * (t + 1)]
                        for i in idx[:b]])
        return {"tokens": out.astype(np.int32)}


def make_source(cfg: DataConfig, path: str | None = None):
    if cfg.kind == "memmap":
        if not path:
            raise ValueError("memmap source needs a path")
        return MemmapTokens(path, cfg)
    return SyntheticLM(cfg)


class Prefetcher:
    """Background-thread prefetch: overlaps host batch synthesis/IO with
    device compute (one of the compute/comm-overlap measures)."""

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self.source = source
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            try:
                self.q.put(self.source.batch(step), timeout=0.2)
                step += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        return self.q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
