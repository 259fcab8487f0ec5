"""Batched LM serving with continuous batching (deliverable b).

    PYTHONPATH=src python -m repro_torch.examples.serve_llm \
        --arch qwen1.5-0.5b [--device cpu]

The port's counterpart of ``examples/serve_llm.py``, on the card by
default. Spins up the slot-based serving engine on a reduced config,
submits a burst of requests, and reports TTFT / throughput. The same
prefill/decode step functions are what the dry run traces at 256/512-chip
scale.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.config.base import ARCH_IDS, get_smoke_config
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None) -> list:
    """Serve the burst; returns the finished requests."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen1.5-0.5b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch)
    eng = ServeEngine(cfg, max_batch=4, max_len=128, eos_id=-1,
                      device=args.device)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for rid in range(args.requests):
        eng.submit(Request(
            rid=rid,
            prompt=rng.integers(0, cfg.vocab_size, 16, dtype=np.int32),
            max_new_tokens=args.max_new))
    done = eng.run_until_drained()
    eng.close()
    wall = time.perf_counter() - t0
    total_tokens = sum(len(r.out_tokens) for r in done)
    ttfts = [r.t_first - r.t_submit for r in done]
    print(f"{len(done)} requests, {total_tokens} tokens in {wall:.2f}s "
          f"({total_tokens/wall:.1f} tok/s aggregate)")
    print(f"TTFT: mean {np.mean(ttfts)*1e3:.0f} ms  "
          f"p max {np.max(ttfts)*1e3:.0f} ms")
    for r in done[:3]:
        print(f"  req {r.rid}: {r.out_tokens}")
    return done


if __name__ == "__main__":
    main()
