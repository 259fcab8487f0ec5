"""Training: ``build_train_step``'s ``train_step``, driven as
``train_loop`` drives it, one whole step at a time from the host batch
to the read-back of its loss.

Set-up makes the weights from the seed (float32 masters, as the cell's
file says), the program's AdamW state and its step, and runs the first
``setup_steps`` steps through that same step and feed. Those steps are
the ones checked: their losses, the first gradient as AdamW got it (its
first moment over ``1 - beta1``), the first step's update made of it,
and each leaf's change after them. The window then goes on with the
same objects, on new rows every step. After the window the program's
state is freed and the reference trains the same start on the same
rows."""

from __future__ import annotations

import gc
import time

import torch

from perfbench import checks, flops, spec, traffic, weights
from perfbench.reference import dense as ref


def program(cell: dict, seed: int, device, fault=None):
    """The program's train step, its state from the seed, and its
    set-up steps. Returns (state, readings, step function)."""
    from repro_torch.config.base import TrainConfig
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train import trainer

    conf, wl, traf = cell["config"], cell["workload"], cell["traffic"]
    tw = wl["train"]
    cfg = spec.port_config(conf, cell["entry"]["config"], dtype=tw["dtype"],
                           remat=tw["remat"])
    tcfg = TrainConfig(microbatches=tw["microbatches"], seed=0,
                       grad_compression=False, **tw["optimizer"])
    shapes = weights.shapes(cfg)
    params = weights.make(conf, shapes, seed, device, torch.float32)
    for p in weights.leaf_paths(params):
        weights.get(params, p).requires_grad_(True)
    opt = adamw_init(params)
    step_fn = trainer.build_train_step(cfg, tcfg)
    if fault is not None:
        step_fn = fault(step_fn)
    vocab = conf["vocab_size"]
    state = {"params": params, "opt": opt, "step": 0}

    def one_step():
        rows = traffic.train_rows(traf, vocab, seed, state["step"])
        batch = trainer.device_batch({"tokens": rows}, device)
        state["params"], state["opt"], m = step_fn(state["params"],
                                                   state["opt"], batch)
        loss = float(m["loss"])          # the read-back that ends a step
        state["step"] += 1
        return loss

    losses, first, grad, after, nu = [], {}, {}, {}, {}
    for k in range(wl["setup_steps"]):
        losses.append(one_step())
        if k == 0:
            # The first clipped gradient, as AdamW got it, and the
            # parameters and second moment AdamW made of it, kept on the
            # host until the reference judges them.
            for p in weights.leaf_paths(shapes):
                g = weights.get(state["opt"]["mu"], p).detach() / (
                    1.0 - tw["optimizer"]["beta1"])
                grad[p] = float(torch.linalg.vector_norm(g))
                first[p] = g.to("cpu")
                after[p] = weights.get(state["params"], p).detach().to(
                    "cpu", copy=True)
                nu[p] = weights.get(state["opt"]["nu"], p).detach().to(
                    "cpu", copy=True)
    with torch.no_grad():
        change = {p: float(torch.linalg.vector_norm(
            weights.get(state["params"], p).detach()
            - weights.redraw(conf, shapes, seed, p, device, torch.float32)))
            for p in weights.leaf_paths(shapes)}
    readings = {"losses": losses, "first": first, "grad": grad,
                "change": change, "after": after, "nu": nu}
    return state, readings, one_step


def reference(cell: dict, seed: int, device, precision: str = "fp32",
              rows: slice = slice(None)) -> dict:
    """The reference's set-up steps from the same start and rows."""
    conf, wl, traf = cell["config"], cell["workload"], cell["traffic"]
    a = spec.arch(conf)
    cfg = spec.port_config(conf, cell["entry"]["config"])
    shapes = weights.shapes(cfg)
    leaves = {p: weights.redraw(conf, shapes, seed, p, device, torch.float32)
              for p in weights.leaf_paths(shapes)}
    batches = [torch.as_tensor(traffic.train_rows(
        traf, conf["vocab_size"], seed, s), device=device)
        for s in range(wl["setup_steps"])]
    ref.strict_fp32()
    out = ref.train(a, cell["workload"]["train"]["optimizer"], leaves,
                    batches, precision=precision, rows=rows)
    del leaves
    out["first"] = {k: g.to("cpu") for k, g in out["first"].items()}
    return out


def update_check(cell: dict, seed: int, prog: dict, device) -> tuple:
    """The first step's AdamW update, followed from the program's own
    first gradient (which ``grad_gap`` and ``grad_dist`` judge against
    the reference's): AdamW applied to the start with that gradient,
    against the program's parameters and second moment after the step.
    The worst leaf's distance over the larger of its own and the median
    leaf's expected change (of the second moment: its norm), and that
    leaf."""
    conf = cell["config"]
    opt = cell["workload"]["train"]["optimizer"]
    shapes = weights.shapes(spec.port_config(conf, cell["entry"]["config"]))
    dx, nx, dv, nv = {}, {}, {}, {}
    with torch.no_grad():
        for p in weights.leaf_paths(shapes):
            x0 = weights.redraw(conf, shapes, seed, p, device, torch.float32)
            x = x0.clone()
            m, v = torch.zeros_like(x), torch.zeros_like(x)
            ref.adamw_(opt, 0, x, prog["first"][p].to(device), m, v)
            dx[p] = float(torch.linalg.vector_norm(prog["after"][p].to(device)
                                                   - x))
            nx[p] = float(torch.linalg.vector_norm(x - x0))
            dv[p] = float(torch.linalg.vector_norm(prog["nu"][p].to(device)
                                                   - v))
            nv[p] = float(torch.linalg.vector_norm(v))
            del x0, x, m, v
    own = lambda d, ref_norm: d
    return max(checks.worst_leaf(dx, nx, measure=own),
               checks.worst_leaf(dv, nv, measure=own))


def compare(prog: dict, r: dict) -> dict:
    """The compared numbers: the widest relative gap of a step's loss;
    the worst leaf's gap between the norms of the first gradient and of
    the change; and the worst leaf's distance between the two first
    gradients (``grad_dist``), each leaf over the larger of its own and
    the median leaf's reference norm."""
    loss_gap = max(abs(p - q) / abs(q) for p, q in zip(prog["losses"],
                                                      r["losses"]))
    grad_gap, grad_at = checks.worst_leaf(prog["grad"], r["grad"])
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    dist = {k: float(torch.linalg.vector_norm(prog["first"][k].to(dev)
                                              - g.to(dev)))
            for k, g in r["first"].items()}
    grad_dist, dist_at = checks.worst_leaf(
        dist, r["grad"], measure=lambda d, ref_norm: d)
    keep = checks.moving_leaves(r["grad"])
    change_gap, change_at = checks.worst_leaf(prog["change"], r["change"],
                                              keep)
    return {"values": {"loss_gap": loss_gap, "grad_gap": grad_gap,
                       "grad_dist": grad_dist, "change_gap": change_gap},
            "notes": {"grad_worst_leaf": grad_at,
                      "grad_dist_worst_leaf": dist_at,
                      "change_worst_leaf": change_at,
                      "program_losses": prog["losses"],
                      "reference_losses": r["losses"],
                      "leaves_left_out_of_change": sorted(
                          "/".join(k) for k in r["grad"] if k not in keep)}}


def free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run(cell: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float, fault=None) -> dict:
    from perfbench.trace import Stretch
    conf, wl, traf = cell["config"], cell["workload"], cell["traffic"]
    a = spec.arch(conf)
    state, readings, one_step = program(cell, seed, device, fault)
    tokens = traf["seqs_per_step"] * traf["seq_len"]

    w0 = time.perf_counter()
    setup_s = w0 - t_start
    n = 0
    while time.perf_counter() - w0 < seconds:
        one_step()
        n += 1
    w1 = time.perf_counter()
    record = {"setup_s": setup_s, "window_s": w1 - w0, "steps": n,
              "tokens": n * tokens,
              "flops": n * flops.train_step(a, traf["seqs_per_step"],
                                            traf["seq_len"]),
              "attempted": n, "failed": 0, "trace": None}
    if trace:
        spans = []
        with Stretch() as st:
            for _ in range(wl["trace_steps"]):
                t0 = time.perf_counter_ns()
                one_step()
                spans.append(("train.step", t0, time.perf_counter_ns()))
        record["trace"] = st.read(spans)
    if torch.cuda.is_available() and torch.device(device).type == "cuda":
        record["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
    state.clear()
    del one_step
    free()
    t0 = time.perf_counter()
    r = reference(cell, seed, device)
    cmp = compare(readings, r)
    cmp["values"]["update_gap"], cmp["notes"]["update_worst_leaf"] = \
        update_check(cell, seed, readings, device)
    record["checks"] = checks.judge(cmp["values"], wl["limits"])
    record["notes"] = dict(cmp["notes"], setup_s=setup_s, window_s=w1 - w0,
                           reference_s=time.perf_counter() - t0)
    return record
