"""The port's backward pass (autograd through ``loss_fn``) against
``jax.value_and_grad`` of the reference's, on all 10 smoke archs, on the
CPU.

* Float32: the reference's ``init_params`` carried over by
  ``convert.params_from_reference``, the same seeded batch; the loss
  within 1e-6 relative and every gradient leaf within 1e-4 of that leaf's
  ``max|g|`` (measured at most 2.6e-6: sum order).
* Bfloat16 (compute; float32 masters): the loss within 1e-3 relative and
  every leaf within 0.1 of its ``max|g|`` (measured at most 4.1e-2). The
  two packages round products and sums at other places, and the
  reference scatter-adds the embedding's cotangents into a bfloat16
  table (it casts, then gathers) where the port accumulates them in
  float32 (it gathers, then casts).
* ``tests/models/test_archs_smoke.py::test_smoke_train_step`` (one SGD
  step: loss and gradient norm finite, the embedding moves) through both
  packages.
* ``remat="full"`` (``torch.utils.checkpoint`` around each layer body)
  gives the same loss and gradients as ``"none"``, bit for bit.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import base as rbase
from repro.models import model as rmodel
from repro_torch.config import base as tbase
from repro_torch.convert import params_from_reference
from repro_torch.models import model as tmodel
from repro_torch.models.tree import tree_items, tree_leaves

ARCH_IDS = tbase.ARCH_IDS
KEY = jax.random.PRNGKey(0)
B, S = 2, 16
TOL = {"float32": (1e-6, 1e-4), "bfloat16": (1e-3, 0.1)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test's torch CPU ops on one thread. Under the parallel test
    workers, more torch threads than cores make its thread teams wait on
    each other: a 60-step smoke train loop took 433 s instead of 3 s."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S + 1),
                                    dtype=np.int32)}
    if cfg.encoder_decoder:
        batch["frames"] = (rng.standard_normal((B, S, cfg.d_model))
                           * 0.02).astype(np.float32)
    if cfg.frontend == "vision":
        batch["patches"] = (rng.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.d_model)) * 0.02).astype(
                np.float32)
    return batch


def _as_port(batch):
    return {k: torch.from_numpy(v.astype(np.int64) if k == "tokens" else v)
            for k, v in batch.items()}


def _port_grads(cfg, params, batch):
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = tmodel.loss_fn(cfg, params, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    by_id = {id(p): g for p, g in zip(leaves, grads)}
    return loss.detach(), [(path, by_id[id(leaf)])
                           for path, leaf in tree_items(params)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_grads_match_jax_value_and_grad(arch, dtype):
    rcfg = dataclasses.replace(rbase.get_smoke_config(arch), dtype=dtype)
    cfg = dataclasses.replace(tbase.get_smoke_config(arch), dtype=dtype)
    rp = rmodel.init_params(rcfg, KEY)
    tp = params_from_reference(cfg, jax.tree.map(np.asarray, rp),
                               device="cpu")
    batch = _batch(cfg)
    (rloss, _), rgrads = jax.jit(jax.value_and_grad(
        lambda p, b: rmodel.loss_fn(rcfg, p, b), has_aux=True))(
            rp, {k: jnp.asarray(v) for k, v in batch.items()})
    tloss, tgrads = _port_grads(cfg, tp, _as_port(batch))
    loss_tol, leaf_tol = TOL[dtype]
    assert abs(float(tloss) - float(rloss)) <= loss_tol * abs(float(rloss))
    want = jax.tree.leaves(rgrads)
    assert len(tgrads) == len(want)
    errs = {}
    for (path, g), w in zip(tgrads, want):
        w = np.asarray(w, np.float32)
        got = np.zeros_like(w) if g is None else g.float().numpy()
        assert got.shape == w.shape, path
        scale = float(np.abs(w).max())
        errs["/".join(path)] = float(np.abs(got - w).max()) / (scale or 1.0)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= leaf_tol, (worst, errs[worst])


# --------------------------------------------------------------------- #
# tests/models/test_archs_smoke.py::test_smoke_train_step, both packages
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_train_step_reference(arch):
    """One SGD step: loss finite, grads finite, params change."""
    cfg = rbase.get_smoke_config(arch)
    params = rmodel.init_params(cfg, KEY)
    batch = {k: jnp.asarray(v) for k, v in _batch(cfg).items()}

    @jax.jit
    def step(p):
        (loss, _), grads = jax.value_and_grad(
            lambda q: rmodel.loss_fn(cfg, q, batch), has_aux=True)(p)
        return loss, jax.tree.map(lambda a, g: a - 1e-3 * g, p, grads), \
            grads

    loss, new_params, grads = step(params)
    assert bool(jnp.isfinite(loss)), f"{arch}: loss not finite"
    gnorm = jnp.sqrt(sum(jnp.sum(g.astype(jnp.float32) ** 2)
                         for g in jax.tree.leaves(grads)))
    assert bool(jnp.isfinite(gnorm)) and float(gnorm) > 0
    assert not np.allclose(np.asarray(params["embed"]["embedding"]),
                           np.asarray(new_params["embed"]["embedding"]))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_train_step_port(arch):
    """The same on the port's own draws (bfloat16 compute)."""
    cfg = tbase.get_smoke_config(arch)
    params = tmodel.init_params(cfg, 0, device="cpu")
    emb0 = params["embed"]["embedding"].clone()
    loss, grads = _port_grads(cfg, params, _as_port(_batch(cfg)))
    assert bool(torch.isfinite(loss)), f"{arch}: loss not finite"
    gs = [g for _, g in grads if g is not None]
    gnorm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in gs))
    assert bool(torch.isfinite(gnorm)) and float(gnorm) > 0
    with torch.no_grad():
        leaves = dict(tree_items(params))
        for path, g in grads:
            if g is not None:
                leaves[path].sub_(1e-3 * g)
    assert not torch.allclose(emb0, params["embed"]["embedding"])


# --------------------------------------------------------------------- #
# remat="full" against "none"
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_remat_full_equals_none_bit_for_bit(arch):
    base = tbase.get_smoke_config(arch)
    assert base.remat == "none"
    batch = _as_port(_batch(base))
    out = {}
    for remat in ("none", "full"):
        cfg = dataclasses.replace(base, remat=remat)
        params = tmodel.init_params(cfg, 0, device="cpu")
        out[remat] = _port_grads(cfg, params, batch)
    (l0, g0), (l1, g1) = out["none"], out["full"]
    assert torch.equal(l0, l1)
    assert [p for p, _ in g0] == [p for p, _ in g1]
    for (path, a), (_, b) in zip(g0, g1):
        assert (a is None) == (b is None), path
        if a is not None:
            assert torch.equal(a, b), path


def test_remat_full_recomputes_the_layer_bodies(monkeypatch):
    """Under ``remat="full"`` each decoder layer body runs twice (forward,
    then again in the backward pass); under ``"none"`` once."""
    calls = []
    real = tmodel._layer_fwd

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tmodel, "_layer_fwd", counting)
    base = tbase.get_smoke_config("qwen1.5-0.5b")
    batch = _as_port(_batch(base))
    for remat, want in (("none", base.n_layers),
                        ("full", 2 * base.n_layers)):
        calls.clear()
        cfg = dataclasses.replace(base, remat=remat)
        _port_grads(cfg, tmodel.init_params(cfg, 0, device="cpu"), batch)
        assert len(calls) == want, remat
