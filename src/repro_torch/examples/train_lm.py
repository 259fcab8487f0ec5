"""End-to-end LM training example (the train-~100M example).

    PYTHONPATH=src python -m repro_torch.examples.train_lm        # ~25M
    PYTHONPATH=src python -m repro_torch.examples.train_lm --preset 100m \
        --steps 300 [--device cpu]

The port's counterpart of ``examples/train_lm.py``, on the card by
default. Uses the full stack: config, synthetic data pipeline with
prefetch, the train step (clipping, schedule, AdamW in place), async
checkpointing with resume, heartbeat monitor. Kill and rerun with the
same ``--ckpt-dir`` to see fault-tolerant resume.
"""

from __future__ import annotations

import argparse

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.config.base import ModelConfig, TrainConfig
from repro_torch.data.pipeline import DataConfig, Prefetcher, SyntheticLM
from repro_torch.distributed.fault_tolerance import HeartbeatMonitor
from repro_torch.train.trainer import TrainLoopHooks, train_loop

PRESETS = {
    # ~25M params: minutes on a CPU.
    "25m": ModelConfig(name="demo-25m", family="dense", n_layers=8,
                       d_model=384, n_heads=6, n_kv_heads=6, head_dim=64,
                       d_ff=1152, vocab_size=4096, vocab_pad_multiple=128,
                       remat="none"),
    # ~100M params (the deliverable-scale run).
    "100m": ModelConfig(name="demo-100m", family="dense", n_layers=12,
                        d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
                        d_ff=2304, vocab_size=8192, vocab_pad_multiple=128,
                        remat="none"),
}


def main(argv=None) -> list[dict]:
    """Train the preset; returns the per-step history."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=PRESETS, default="25m")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = PRESETS[args.preset]
    n_params = cfg.param_count()
    print(f"model {cfg.name}: {n_params/1e6:.1f}M params")
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=30,
                       total_steps=args.steps, checkpoint_every=100)
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start = (ckpt.latest_step() or 0) if ckpt else 0
    data = Prefetcher(SyntheticLM(DataConfig(
        seq_len=args.seq_len, global_batch=args.batch,
        vocab_size=cfg.vocab_size)), start_step=start)
    monitor = HeartbeatMonitor()

    def on_step(step, metrics, dt):
        monitor.beat("w0", dt)
        if step % 10 == 0 or step == args.steps - 1:
            toks = args.batch * args.seq_len / dt
            print(f"step {step:4d} loss {metrics['loss']:.4f} "
                  f"gnorm {metrics['grad_norm']:.2f} {toks:,.0f} tok/s",
                  flush=True)

    try:
        _, _, hist = train_loop(cfg, tcfg, data, args.steps, checkpoint=ckpt,
                                hooks=TrainLoopHooks(on_step=on_step),
                                device=args.device)
    finally:
        data.close()
    if hist:
        print(f"done: loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f} "
              f"({len(hist)} steps run)")
    else:
        print("done: 0 steps run")
    return hist


if __name__ == "__main__":
    main()
