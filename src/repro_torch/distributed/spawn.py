"""Start one process per rank, each in an initialised process group.

The counterpart of the reference's multi-device subprocess (its tests
force 8 host devices in a child interpreter): :func:`run_ranks` starts
``world`` processes with ``torch.multiprocessing`` (the ``spawn`` start
method), joins them through a ``file://`` rendezvous in a fresh temporary
directory (no TCP port, so concurrent runs never collide), and calls
``fn(rank, world, *args)`` in each. On CUDA each rank takes card
``rank`` and the ``nccl`` backend; ``device="cpu"`` takes ``gloo``.
Nothing falls back: a host with too few cards raises, a rank that raises
fails the whole run (the other ranks are stopped), and a collective that
waits longer than ``timeout_s`` fails its rank.

``fn`` must be importable by name (a module-level function), and its
result picklable; tensors in it come back on the CPU.
"""

from __future__ import annotations

import datetime
import os
import tempfile
import time

import torch


def _rank_main(rank: int, fn, world: int, tmp: str, device: str,
               timeout_s: float) -> None:
    import torch.distributed as dist
    args = torch.load(os.path.join(tmp, "args.pt"), weights_only=False)
    if device == "cuda":
        torch.cuda.set_device(rank)
    else:  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(
        "nccl" if device == "cuda" else "gloo",
        init_method=f"file://{os.path.join(tmp, 'rendezvous')}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        result = fn(rank, world, *args)
        torch.save(result, os.path.join(tmp, f"result{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, *args, device: str = "cuda",
              timeout_s: float = 300.0) -> list:
    """``fn(rank, world, *args)`` in ``world`` processes; returns their
    results in rank order. Raises the first failing rank's error
    (``torch.multiprocessing.ProcessRaisedException``), or
    ``TimeoutError`` when the ranks have not all ended after
    ``timeout_s`` seconds (they are then terminated)."""
    import torch.multiprocessing as mp
    if device not in ("cuda", "cpu"):
        raise ValueError(f"run_ranks: device {device!r} is not cuda or cpu")
    if device == "cuda" and torch.cuda.device_count() < world:
        raise RuntimeError(f"run_ranks: {world} ranks need {world} CUDA "
                           f"cards, {torch.cuda.device_count()} visible")
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        # The arguments go through a file: a process's start blocks until
        # the child reads what it is sent, so large ones would start the
        # ranks one after another.
        torch.save(args, os.path.join(tmp, "args.pt"))
        ctx = mp.spawn(_rank_main, args=(fn, world, tmp, device, timeout_s),
                       nprocs=world, join=False)
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=max(0.0, min(
                    5.0, deadline - time.monotonic()))):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"run_ranks: {world} ranks of "
                                       f"{getattr(fn, '__name__', fn)} "
                                       f"still running after {timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                    p.join(10)
        return [torch.load(os.path.join(tmp, f"result{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(world)]
