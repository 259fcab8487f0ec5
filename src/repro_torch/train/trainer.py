"""Training loop: the train step (gradient accumulation, clipping,
warmup-cosine schedule, optional int8 grad compression, AdamW in place),
checkpoint/resume, heartbeat + straggler hooks.

The port's copy of ``repro.train.trainer``. Autograd takes the backward
pass; microbatches accumulate in a Python loop in the order of the
reference's ``lax.scan``; params and optimizer state are updated in place
(the reference's donated buffers). Batches come from the data pipeline as
host NumPy and reach the device through pinned memory.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.config.base import ModelConfig, TrainConfig
from repro_torch.models.model import init_params, loss_fn
from repro_torch.models.tree import tree_leaves, tree_map
from repro_torch.train import grad_compress
from repro_torch.train.optimizer import (AdamWConfig, adamw_init, adamw_update,
                                         clip_by_global_norm, warmup_cosine)


def init_train_state(cfg: ModelConfig, tcfg: TrainConfig,
                     generator: torch.Generator | None = None,
                     device="cuda"):
    """Params (float32 masters that require grad) and AdamW state on
    ``device``, drawn from ``generator`` (default: a ``torch.Generator``
    on ``device`` seeded with ``tcfg.seed``)."""
    params = init_params(cfg, tcfg.seed if generator is None else generator,
                         device=device)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    opt = adamw_init(params)
    if tcfg.grad_compression:
        opt["err"] = grad_compress.init_error(params)
    return params, opt


def device_batch(batch: dict, device) -> dict:
    """A host NumPy batch as tensors on ``device`` (token ids as int64),
    copied from pinned memory on a CUDA device."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.require(
            v, np.int64 if k == "tokens" else None, "C"))
        if device.type == "cuda":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=True)
    return out


def loss_and_grads(cfg: ModelConfig, tcfg: TrainConfig, params, batch: dict
                   ) -> tuple[torch.Tensor, dict, Any]:
    """(loss, metrics, grads) of ``loss_fn`` over ``batch``, its leading
    dim split into ``tcfg.microbatches`` accumulation slices: float32
    gradient sums in microbatch order, then divided by their count.
    Microbatched metrics carry ``"nll": loss``, as the reference's do."""
    leaves = tree_leaves(params)
    for p in leaves:
        if not p.requires_grad:
            p.requires_grad_(True)

    def one(b):
        loss, metrics = loss_fn(cfg, params, b, z_loss=tcfg.z_loss,
                                moe_aux=tcfg.moe_aux_loss)
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        gs = [torch.zeros_like(p) if g is None else g
              for p, g in zip(leaves, gs)]
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, gs

    mb = tcfg.microbatches
    if mb > 1:
        gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in leaves]
        lsum = 0.0
        for i in range(mb):
            micro = {k: v.reshape(mb, v.shape[0] // mb, *v.shape[1:])[i]
                     for k, v in batch.items()}
            loss, _, gs = one(micro)
            gsum = [a + g for a, g in zip(gsum, gs)]
            lsum = lsum + loss
        flat = [g / mb for g in gsum]
        loss = lsum / mb
        metrics = {"nll": loss}
    else:
        loss, metrics, flat = one(batch)
    it = iter(flat)
    return loss, metrics, tree_map(lambda _: next(it), params)


def build_train_step(cfg: ModelConfig, tcfg: TrainConfig
                     ) -> Callable[..., Any]:
    """Returns train_step(params, opt_state, batch) -> (params, opt,
    metrics); ``batch`` holds tensors on the params' device. Params and
    the AdamW moments are updated in place and returned."""
    acfg = AdamWConfig(learning_rate=tcfg.learning_rate,
                       beta1=tcfg.beta1, beta2=tcfg.beta2, eps=tcfg.eps,
                       weight_decay=tcfg.weight_decay)

    def train_step(params, opt_state, batch):
        loss, metrics, grads = loss_and_grads(cfg, tcfg, params, batch)
        if tcfg.grad_compression:
            grads, new_err = grad_compress.compress_grads_with_feedback(
                grads, opt_state["err"])
        grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
        lr_scale = warmup_cosine(opt_state["step"], tcfg.warmup_steps,
                                 tcfg.total_steps)
        core_state = {k: opt_state[k] for k in ("mu", "nu", "step")}
        new_params, new_core = adamw_update(acfg, params, grads, core_state,
                                            lr_scale)
        new_opt = dict(new_core)
        if tcfg.grad_compression:
            new_opt["err"] = new_err
        metrics = dict(metrics)
        metrics["loss"] = loss
        metrics["grad_norm"] = gnorm
        metrics["lr_scale"] = lr_scale
        return new_params, new_opt, metrics

    return train_step


@dataclasses.dataclass
class TrainLoopHooks:
    on_step: Callable[[int, dict, float], None] | None = None
    heartbeat: Callable[[float], None] | None = None


def train_loop(cfg: ModelConfig, tcfg: TrainConfig, data_iter,
               n_steps: int, checkpoint=None, resume: bool = True,
               hooks: TrainLoopHooks | None = None, device="cuda"):
    """Run n_steps on ``device``; returns (params, opt_state, history).
    A step's time runs from its host batch to the read-back of its
    loss."""
    hooks = hooks or TrainLoopHooks()
    params, opt = init_train_state(cfg, tcfg, device=device)
    start = 0
    if checkpoint is not None and resume:
        latest = checkpoint.latest_step()
        if latest is not None:
            params, opt, meta = checkpoint.restore(latest, params, opt,
                                                   device=device)
            start = meta["step"]
    step_fn = build_train_step(cfg, tcfg)
    history = []
    for step in range(start, n_steps):
        batch = next(data_iter)
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(params, opt,
                                       device_batch(batch, device))
        metrics["loss"].item()
        dt = time.perf_counter() - t0
        if hooks.heartbeat:
            hooks.heartbeat(dt)
        history.append({k: float(v) for k, v in metrics.items()})
        if hooks.on_step:
            hooks.on_step(step, history[-1], dt)
        if checkpoint is not None and tcfg.checkpoint_every and \
                (step + 1) % tcfg.checkpoint_every == 0:
            checkpoint.save(step + 1, params, opt)
    if checkpoint is not None:
        checkpoint.save(n_steps, params, opt)
        checkpoint.wait()
    return params, opt, history
