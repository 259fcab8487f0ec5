"""Serving driver: continuous-batching engine over a (smoke or full) arch.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
      --smoke --requests 8 --max-new 16 [--device cpu]

The reference's flags and printed line; the model, its caches and the
stop predicate's PuM device run on ``--device`` (the card by default).
Weights are drawn from ``torch.Generator`` seed 0.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from repro_torch.config.base import ARCH_IDS, get_config, get_smoke_config
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    eng = ServeEngine(cfg, max_batch=args.max_batch, max_len=args.max_len,
                      eos_id=-1, device=args.device)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for rid in range(args.requests):
        eng.submit(Request(
            rid=rid,
            prompt=rng.integers(0, cfg.vocab_size, args.prompt_len,
                                dtype=np.int32),
            max_new_tokens=args.max_new))
    done = eng.run_until_drained()
    wall = time.perf_counter() - t0
    eng.close()
    total = sum(len(r.out_tokens) for r in done)
    ttft = [r.t_first - r.t_submit for r in done]
    print(f"[serve] {args.arch}: {len(done)} requests, {total} tokens, "
          f"{total/wall:.1f} tok/s, TTFT mean {np.mean(ttft)*1e3:.0f} ms "
          f"max {np.max(ttft)*1e3:.0f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
