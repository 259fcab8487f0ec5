"""Step builders + shape-only input specs for every (arch x shape) cell.

The port's copy of ``repro.launch.steps``. ``input_specs`` returns
``meta`` tensors (shape and dtype, no storage) where the reference
returns ``ShapeDtypeStruct`` stand-ins; ``build_cell`` returns the step
function plus the full argument spec/sharding trees — shared by the
analytic dry run (``launch/dryrun.py``), the roofline analysis, and
(with real tensors) the train/serve drivers. The reference's
``Cell.lower()`` has no counterpart: the port has no ahead-of-time
compiler. A cell's ``fn`` is called on real tensors in one process (or,
by the dry run, on its ``meta`` arguments), and :meth:`Cell.run`
executes it across the ranks of a ``DeviceMesh`` as DTensors under its
shardings, as the reference's ``jax.jit(fn, in_shardings=...,
out_shardings=...)(*args)`` does over its mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.config.base import (ModelConfig, ShapeConfig, TrainConfig,
                                     get_config)
from repro_torch.distributed.constraints import use_mesh
from repro_torch.distributed.sharding import (P, Sharding, batch_shardings,
                                              cache_shardings,
                                              distribute_tree,
                                              param_shardings)
from repro_torch.launch.mesh import Mesh
from repro_torch.models.model import (decode_step, init_cache, init_params,
                                      prefill, torch_dtype)
from repro_torch.models.tree import tree_map
from repro_torch.train.grad_compress import init_error
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.trainer import build_train_step


def _spec(shape, dtype: str) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=torch_dtype(dtype), device="meta")


# ----------------------------------------------------------------------- #
# Input specs per cell
# ----------------------------------------------------------------------- #

def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Training/prefill batch stand-ins. For enc-dec, the seq budget splits
    between source frames and target tokens; for VLM, patch tokens come out
    of the text budget."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        if cfg.encoder_decoder:
            half = s // 2
            return {"frames": _spec((b, half, cfg.d_model), "float32"),
                    "tokens": _spec((b, half + 1), "int32")}
        if cfg.frontend == "vision":
            n_txt = s - cfg.n_frontend_tokens
            return {"patches": _spec((b, cfg.n_frontend_tokens, cfg.d_model),
                                     "float32"),
                    "tokens": _spec((b, n_txt + 1), "int32")}
        return {"tokens": _spec((b, s + 1), "int32")}
    # prefill
    if cfg.encoder_decoder:
        return {"frames": _spec((b, cfg.n_frontend_tokens, cfg.d_model),
                                "float32"),
                "tokens": _spec((b, s), "int32")}
    if cfg.frontend == "vision":
        return {"patches": _spec((b, cfg.n_frontend_tokens, cfg.d_model),
                                 "float32"),
                "tokens": _spec((b, s - cfg.n_frontend_tokens), "int32")}
    return {"tokens": _spec((b, s), "int32")}


def params_specs(cfg: ModelConfig, dtype: str | None = None) -> Any:
    tree = init_params(cfg, device="meta")
    if dtype is None:
        return tree
    dt = torch_dtype(dtype)
    return tree_map(lambda x: x.to(dt) if x.is_floating_point() else x,
                    tree)


def opt_specs(params_tree: Any) -> Any:
    return adamw_init(params_tree)


def cache_specs(cfg: ModelConfig, shape: ShapeConfig) -> Any:
    b, s = shape.global_batch, shape.seq_len
    return init_cache(cfg, b, s, torch.bfloat16, device="meta")


def input_specs(arch: str, shape: ShapeConfig) -> dict:
    """Every model input of the cell as a ``meta`` tensor, keyed by
    argument name."""
    cfg = get_config(arch)
    if shape.kind == "train":
        params = params_specs(cfg)
        return {"params": params, "opt_state": opt_specs(params),
                "batch": batch_specs(cfg, shape)}
    if shape.kind == "prefill":
        return {"params": params_specs(cfg, "bfloat16"),
                "batch": batch_specs(cfg, shape)}
    spec = {"params": params_specs(cfg, "bfloat16"),
            "caches": cache_specs(cfg, shape),
            "token": _spec((shape.global_batch,), "int32"),
            "pos": _spec((shape.global_batch,), "int32")}
    if cfg.encoder_decoder:
        spec["memory"] = _spec((shape.global_batch, cfg.n_frontend_tokens,
                                cfg.d_model), "bfloat16")
    return spec


# ----------------------------------------------------------------------- #
# Cell = (fn, arg specs, in_shardings, out_shardings, donate)
# ----------------------------------------------------------------------- #

@dataclasses.dataclass
class Cell:
    arch: str
    shape: ShapeConfig
    fn: Callable
    args: tuple
    in_shardings: tuple
    out_shardings: Any
    donate_argnums: tuple

    def run(self, args: tuple, device_mesh) -> Any:
        """``fn`` on real ``args`` across the ranks of ``device_mesh``
        (every rank calls it with the same full tensors, or with DTensors
        already placed): each argument is placed by ``in_shardings``,
        ``fn`` runs with the mesh current (the model's constraints act)
        and with plain tensors it makes treated as replicated, and each
        output is laid out by ``out_shardings`` (``None`` leaves it as
        it comes). ``donate_argnums`` is not acted on: the steps already
        write their donated arguments (params, moments, caches) in
        place."""
        from torch.distributed.tensor.experimental import \
            implicit_replication
        placed = distribute_tree(tuple(args), self.in_shardings,
                                 device_mesh)
        with use_mesh(device_mesh), implicit_replication():
            out = self.fn(*placed)
        return distribute_tree(out, self.out_shardings, device_mesh)


def build_cell(arch: str, shape: ShapeConfig, mesh: Mesh,
               tcfg: TrainConfig | None = None,
               overrides: dict | None = None) -> Cell:
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    tcfg = tcfg or TrainConfig()
    # Memory-tier rule for training:
    #   small: params+moments replicated over data (pure TP+DP),
    #   medium (moments don't fit TP-only): ZeRO-2-style — params TP-only,
    #     moments FSDP over data (grads reduce-scatter + params re-gather,
    #     same wire bytes as the plain all-reduce; NO per-layer weight
    #     gathers in fwd/bwd),
    #   huge (params alone don't fit TP-only): full ZeRO-3 FSDP.
    param_fsdp = cfg.param_count() * 4 / 16 > 10e9
    opt_fsdp = param_fsdp or cfg.param_count() * 12 / 16 > 12e9
    if shape.kind == "train":
        params = params_specs(cfg)
        opt = opt_specs(params)
        batch = batch_specs(cfg, shape)
        p_sh = param_shardings(cfg, mesh, params, fsdp=param_fsdp)
        o_sh = {"mu": param_shardings(cfg, mesh, opt["mu"], fsdp=opt_fsdp),
                "nu": param_shardings(cfg, mesh, opt["nu"], fsdp=opt_fsdp),
                "step": Sharding(mesh, P())}
        if tcfg.grad_compression:
            # The step reads and returns the error-feedback buffers; each
            # takes its parameter's sharding.
            opt["err"] = init_error(params)
            o_sh["err"] = p_sh
        b_sh = batch_shardings(mesh, batch)
        fn = build_train_step(cfg, tcfg)
        return Cell(arch, shape, fn, (params, opt, batch),
                    (p_sh, o_sh, b_sh), (p_sh, o_sh, None),
                    donate_argnums=(0, 1))
    # Serving: TP-only weights (latency path) unless the bf16 TP shard
    # exceeds device memory (deepseek-v2-class -> FSDP-gathered weights);
    # SMALL models (<4 GB bf16) instead replicate weights and run
    # sequence-parallel on the model axis — no per-layer FFN all-reduce.
    pbytes = cfg.param_count() * 2
    serve_fsdp = pbytes / 16 > 12e9
    serve_sp = pbytes <= 4e9
    if serve_sp and shape.kind in ("prefill", "decode"):
        cfg = dataclasses.replace(cfg, serve_seq_parallel=True)
    if shape.kind == "prefill":
        params = params_specs(cfg, "bfloat16")
        batch = batch_specs(cfg, shape)
        p_sh = param_shardings(cfg, mesh, params, fsdp=serve_fsdp,
                               tp=not serve_sp)
        b_sh = batch_shardings(mesh, batch)
        caches = cache_specs(cfg, shape)
        c_sh = cache_shardings(cfg, mesh, caches)

        def prefill_fn(p, b):
            logits, caches_out, memory = prefill(cfg, p, b, shape.seq_len)
            return logits, caches_out, memory

        mem_sh = None
        return Cell(arch, shape, prefill_fn, (params, batch),
                    (p_sh, b_sh), (None, c_sh, mem_sh), donate_argnums=())
    # decode
    params = params_specs(cfg, "bfloat16")
    caches = cache_specs(cfg, shape)
    p_sh = param_shardings(cfg, mesh, params, fsdp=serve_fsdp,
                           tp=not serve_sp)
    c_sh = cache_shardings(cfg, mesh, caches)
    tok = _spec((shape.global_batch,), "int32")
    pos = _spec((shape.global_batch,), "int32")
    t_sh = batch_shardings(mesh, tok)
    args: tuple = (params, caches, tok, pos)
    in_sh: tuple = (p_sh, c_sh, t_sh, t_sh)
    if cfg.encoder_decoder:
        mem = _spec((shape.global_batch, cfg.n_frontend_tokens, cfg.d_model),
                    "bfloat16")
        m_sh = batch_shardings(mesh, mem)

        def decode_fn(p, c, t, q, memory):
            return decode_step(cfg, p, c, t, q, memory=memory)

        args = args + (mem,)
        in_sh = in_sh + (m_sh,)
    else:
        def decode_fn(p, c, t, q):
            return decode_step(cfg, p, c, t, q)

    return Cell(arch, shape, decode_fn, args, in_sh, (None, c_sh),
                donate_argnums=(1,))
