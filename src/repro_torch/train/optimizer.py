"""Optimizers (AdamW, SGD+momentum), LR schedules, global-norm clipping.

The port's copy of ``repro.train.optimizer``. States are trees mirroring
the params (``repro_torch.models.tree``). The updates write params and
moments in place under ``torch.no_grad()`` (the counterpart of the
reference's donated buffers) and return the trees, so the signatures
match. The float32 arithmetic keeps the reference's order; sums over
leaves follow JAX's flatten order (dict keys sorted).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.models.tree import tree_items, tree_leaves, tree_map

Params = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    learning_rate: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1


def _step0(params: Params) -> torch.Tensor:
    leaves = tree_leaves(params)
    return torch.zeros((), dtype=torch.int32,
                       device=leaves[0].device if leaves else None)


def adamw_init(params: Params) -> dict:
    return {"mu": tree_map(torch.zeros_like, params),
            "nu": tree_map(torch.zeros_like, params),
            "step": _step0(params)}


def global_norm(tree: Params) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.detach().float()))
                          for _, x in tree_items(tree)))


def clip_by_global_norm(grads: Params, max_norm: float
                        ) -> tuple[Params, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Params, grads: Params,
                 state: dict, lr_scale: torch.Tensor | float = 1.0
                 ) -> tuple[Params, dict]:
    """One AdamW step: ``params``, ``mu``, ``nu`` and ``step`` are updated
    in place and returned."""
    step = state["step"]
    step += 1
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()
    lr = cfg.learning_rate * lr_scale

    def upd(p, g, mu, nu):
        g = g.float()
        mu.mul_(b1).add_((1 - b1) * g)
        nu.mul_(b2).add_((1 - b2) * g * g)
        mhat = mu / bc1
        nhat = nu / bc2
        p32 = p.float()
        p.copy_(p32 - lr * (mhat / (torch.sqrt(nhat) + cfg.eps)
                            + cfg.weight_decay * p32))

    tree_map(upd, params, grads, state["mu"], state["nu"])
    return params, {"mu": state["mu"], "nu": state["nu"], "step": step}


def sgd_momentum_init(params: Params) -> dict:
    return {"mom": tree_map(torch.zeros_like, params), "step": _step0(params)}


@torch.no_grad()
def sgd_momentum_update(params: Params, grads: Params, state: dict,
                        lr: float, momentum: float = 0.9
                        ) -> tuple[Params, dict]:
    """One SGD+momentum step, in place like :func:`adamw_update`."""
    def upd(p, g, m):
        m.mul_(momentum).add_(g.float())
        p.copy_(p.float() - lr * m)

    tree_map(upd, params, grads, state["mom"])
    state["step"] += 1
    return params, {"mom": state["mom"], "step": state["step"]}


def warmup_cosine(step: torch.Tensor, warmup: int, total: int,
                  floor: float = 0.1) -> torch.Tensor:
    """LR multiplier: linear warmup then cosine decay to `floor`."""
    step = torch.as_tensor(step).float()
    warm = step / max(1.0, warmup)
    prog = torch.clamp((step - warmup) / max(1.0, total - warmup), 0, 1)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < warmup, warm, cos)
