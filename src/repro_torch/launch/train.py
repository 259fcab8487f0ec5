"""End-to-end training launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
      --smoke --steps 300 --ckpt-dir runs/run1 [--device cpu]

The reference's flags and printed lines, plus ``--device`` (the card by
default). Wires together: config registry, synthetic/memmap data +
prefetch, the train step (accumulation, clipping, schedule, AdamW in
place), checkpoint manager (async, resume), heartbeat/straggler monitor,
supervisor-compatible exit codes. ``--simulate-preemption N`` ends the
process at step N with exit code 42, once the pending checkpoint write
has finished, to exercise the Supervisor + resume path.
"""

from __future__ import annotations

import argparse
import os
import sys

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.config.base import (ARCH_IDS, TrainConfig, get_config,
                                     get_smoke_config)
from repro_torch.data.pipeline import DataConfig, Prefetcher, make_source
from repro_torch.distributed.fault_tolerance import HeartbeatMonitor
from repro_torch.train.trainer import TrainLoopHooks, train_loop

PREEMPTED = 42


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--data", default=None, help="memmap token file")
    ap.add_argument("--simulate-preemption", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    tcfg = TrainConfig(learning_rate=args.lr, warmup_steps=20,
                       total_steps=args.steps,
                       microbatches=args.microbatches,
                       grad_compression=args.grad_compression,
                       checkpoint_every=args.ckpt_every)
    dcfg = DataConfig(seq_len=args.seq_len, global_batch=args.global_batch,
                      vocab_size=cfg.vocab_size,
                      kind="memmap" if args.data else "synthetic-lm")
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    monitor = HeartbeatMonitor()
    start_step = 0
    if ckpt is not None and not args.no_resume:
        start_step = ckpt.latest_step() or 0
    data = Prefetcher(make_source(dcfg, args.data), start_step=start_step)

    def on_step(step, metrics, dt):
        monitor.beat("worker0", dt)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {metrics['loss']:.4f} "
                  f"nll {metrics['nll']:.4f} gnorm {metrics['grad_norm']:.3f} "
                  f"{dt*1e3:.0f} ms", flush=True)
        if args.simulate_preemption and step + 1 >= args.simulate_preemption:
            print(f"[train] simulated preemption at step {step + 1}",
                  flush=True)
            data.close()
            if ckpt is not None:
                ckpt.wait()
            os._exit(PREEMPTED)

    try:
        params, opt, history = train_loop(
            cfg, tcfg, data, args.steps, checkpoint=ckpt,
            resume=not args.no_resume,
            hooks=TrainLoopHooks(on_step=on_step,
                                 heartbeat=lambda dt: None),
            device=args.device)
    finally:
        data.close()
    first = history[0]["loss"] if history else float("nan")
    last = history[-1]["loss"] if history else float("nan")
    print(f"[train] {args.arch}: loss {first:.4f} -> {last:.4f} over "
          f"{len(history)} steps")
    return 0


if __name__ == "__main__":
    sys.exit(main())
