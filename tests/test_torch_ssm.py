"""The SSM prefill state and the sub-quadratic family against the reference.

* ``_ssm_prefill_cache``, the decode handoff of every SSM and hybrid
  layer, against the reference's (a ``lax.scan`` over tokens, run here
  on the CPU as it is) on seeded NumPy inputs with a non-zero initial
  state, at prompt lengths shorter than the conv window, equal to and
  one past the smoke chunk, and of many chunks: the state within 1e-5 of
  its largest magnitude in float32 (the closed form sums in another
  order; measured at most 4.4e-7), the conv window equal.
* The closed form issues a fixed number of ops: under
  ``TorchDispatchMode`` a 4096-token prefill state costs fewer than
  ``t / 8`` of them, so a loop over tokens cannot come back.
* mamba2-130m and hymba-1.5b smoke configs: prefill of a prompt of two
  chunks and a tail, then 4 greedy decode steps, logits within the float32
  bound of ``tests/test_torch_lm.py`` (1e-5) with the reference's tokens.
* Under strong decay (a decay sum above 88.7 inside one chunk, where
  ``exp`` overflows in float32) the chunked SSD's forward equals the
  reference's and its gradients are finite and equal the per-token
  oracle's (``ssm_naive``) within 1e-3 of each leaf's largest magnitude
  (a chunk's decay weight ``exp(cum_t - cum_s)`` carries an exponent
  error of float32 eps times the chunk's decay sum, here ~300, so ~4e-5;
  ``a_log``'s gradient, a cancelling sum, reads 6.2e-4, every other leaf
  under 4e-6), where the reference's gradients are NaN
  (its ``where(mask, exp(rel), 0)`` backward makes 0 * inf above the
  diagonal): hymba-1.5b's ``train_4k`` cell met it at full width.
* The analytic dry run of both archs' ``prefill_32k`` cell records a
  collective census inside the 240 s ``--cell-timeout`` of the sweep.
"""

from __future__ import annotations

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.config import base as rbase
from repro.models import model as rmodel
from repro.models import ssm as rssm
from repro_torch.config import base as tbase
from repro_torch.convert import params_from_reference
from repro_torch.launch import dryrun
from repro_torch.models import model as tmodel
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.tree import tree_map

STATE_REL_TOL = 1e-5     # of the state's largest magnitude, float32
F32_TOL = 1e-5           # logits, as tests/test_torch_lm.py
CELL_TIMEOUT_S = 240     # the sweep's --cell-timeout (ROADMAP.md section 3)
KEY = jax.random.PRNGKey(0)
ARCHS = ("mamba2-130m", "hymba-1.5b")


def _layer(arch: str, seed: int = 0):
    """One SSM layer's parameters of ``arch``'s smoke config: the
    reference's draw with per-head decays and a conv bias made non-trivial,
    and the same values as port tensors."""
    rcfg = rbase.get_smoke_config(arch)
    cfg = tbase.get_smoke_config(arch)
    rng = np.random.default_rng(seed)
    rp = rssm.ssm_params(KEY, rcfg)
    _, nh = rssm.ssm_dims(rcfg)
    rp = {**rp, "a_log": jnp.asarray(rng.uniform(-1.5, 1.0, nh), jnp.float32),
          "conv_b": rp["conv_b"] + 0.05}
    tp = tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)),
                  jax.tree.map(np.asarray, rp))
    return cfg, rcfg, tp, rp


def _inputs(cfg, t: int, seed: int = 1):
    rng = np.random.default_rng(seed)
    _, nh = ssm_mod.ssm_dims(cfg)
    h = (rng.standard_normal((2, t, cfg.d_model)) * 0.5).astype(np.float32)
    state = rng.standard_normal(
        (2, nh, cfg.ssm_state, cfg.ssm_head_dim)).astype(np.float32)
    return h, state


@pytest.mark.parametrize("t", [1, 2, 16, 17, 256, 4096])
def test_prefill_state_matches_reference(t):
    # hymba-1.5b's smoke SSM layer has mamba2-130m's smoke dims.
    cfg, rcfg, tp, rp = _layer("mamba2-130m")
    h, state = _inputs(cfg, t)
    got = tmodel._ssm_prefill_cache(cfg, tp, torch.from_numpy(h),
                                    {"state": torch.from_numpy(state)})
    want = rmodel._ssm_prefill_cache(rcfg, rp, jnp.asarray(h),
                                     {"state": jnp.asarray(state)})
    ws = np.asarray(want["state"])
    err = np.abs(got["state"].numpy() - ws).max() / np.abs(ws).max()
    assert err <= STATE_REL_TOL, err
    wc = np.asarray(want["conv"])
    assert got["conv"].shape == wc.shape
    np.testing.assert_allclose(got["conv"].numpy(), wc,
                               atol=STATE_REL_TOL * np.abs(wc).max())


def test_final_state_equals_the_per_token_recurrence():
    cfg, _, tp, _ = _layer("mamba2-130m")
    rng = np.random.default_rng(2)
    _, nh = ssm_mod.ssm_dims(cfg)
    n, pdim = cfg.ssm_state, cfg.ssm_head_dim
    x = torch.from_numpy(rng.standard_normal((2, 300, nh, pdim))
                         .astype(np.float32))
    dt = torch.from_numpy(rng.uniform(0.0, 0.3, (2, 300, nh))
                          .astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, 300, n)).astype(np.float32))
    s0 = torch.from_numpy(rng.standard_normal((2, nh, n, pdim))
                          .astype(np.float32))
    got = ssm_mod.final_state(x, dt, tp["a_log"], b, s0)
    want = ssm_mod.final_state_naive(x, dt, tp["a_log"], b, s0)
    assert float((got - want).abs().max() / want.abs().max()) <= \
        STATE_REL_TOL


def test_chunked_ssd_gradients_stay_finite_under_strong_decay():
    cfg, rcfg, tp, rp = _layer("mamba2-130m")
    _, nh = ssm_mod.ssm_dims(cfg)
    a_log = np.full(nh, 5.0, np.float32)      # A = -148 per unit of dt
    rp = {**rp, "a_log": jnp.asarray(a_log)}
    tp = {**tp, "a_log": torch.from_numpy(a_log)}
    u = (np.random.default_rng(4).standard_normal((2, 32, cfg.d_model))
         * 0.5).astype(np.float32)

    def port_grads(fn):
        p = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
        y = fn(cfg, p, torch.from_numpy(u))
        y.square().sum().backward()
        return y.detach().numpy(), {k: v.grad.numpy() for k, v in p.items()}

    y, g = port_grads(ssm_mod.ssm_forward)
    y_naive, g_naive = port_grads(ssm_mod.ssm_naive)
    ry = np.asarray(rssm.ssm_forward(rcfg, rp, jnp.asarray(u)))
    rg = jax.grad(lambda p: jnp.sum(
        rssm.ssm_forward(rcfg, p, jnp.asarray(u)) ** 2))(rp)
    assert np.abs(y - ry).max() <= 2e-5 * np.abs(ry).max()
    assert not all(np.isfinite(np.asarray(v)).all() for v in rg.values())
    for k, want in g_naive.items():
        assert np.isfinite(g[k]).all(), k
        assert np.abs(g[k] - want).max() <= 1e-3 * np.abs(want).max(), k


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def test_prefill_state_op_count_does_not_grow_with_tokens():
    t = 4096
    cfg, _, tp, _ = _layer("mamba2-130m")
    h, state = _inputs(cfg, t)
    cache = {"state": torch.from_numpy(state)}
    with _CountOps() as ops:
        tmodel._ssm_prefill_cache(cfg, tp, torch.from_numpy(h), cache)
    assert 0 < ops.n < t / 8, ops.n


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_prefill_then_decode_matches_reference(arch):
    """A 40-token prompt (two 16-token chunks and a tail of 8), then 4
    greedy decode steps, through both packages from the reference's
    parameters."""
    rcfg = dataclasses.replace(rbase.get_smoke_config(arch),
                               dtype="float32")
    cfg = dataclasses.replace(tbase.get_smoke_config(arch), dtype="float32")
    rp = rmodel.init_params(rcfg, KEY)
    tp = params_from_reference(cfg, jax.tree.map(np.asarray, rp),
                               device="cpu")
    b, s, steps = 2, 40, 4
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (b, s))
    rlog, rc, _ = jax.jit(lambda p, x: rmodel.prefill(
        rcfg, p, {"tokens": x}, s + steps))(rp, jnp.asarray(tokens,
                                                           jnp.int32))
    tlog, tc, _ = tmodel.prefill(cfg, tp, {"tokens": torch.from_numpy(
        tokens.astype(np.int64))}, s + steps)
    errs = [np.abs(tlog.numpy() - np.asarray(rlog)).max()]
    rdec = jax.jit(lambda p, c, x, q: rmodel.decode_step(rcfg, p, c, x, q))
    for i in range(steps):
        rtok = np.asarray(jnp.argmax(rlog[:, :cfg.vocab_size], -1))
        ttok = tlog[:, :cfg.vocab_size].argmax(-1).numpy()
        assert (rtok == ttok).all(), (i, rtok, ttok)
        pos = np.full(b, s + i)
        rlog, rc = rdec(rp, rc, jnp.asarray(rtok), jnp.asarray(pos,
                                                               jnp.int32))
        tlog, tc = tmodel.decode_step(cfg, tp, tc, torch.from_numpy(
            rtok.astype(np.int64)), torch.from_numpy(pos))
        errs.append(np.abs(tlog.numpy() - np.asarray(rlog)).max())
    assert max(errs) < F32_TOL, errs


@pytest.mark.parametrize("arch", ARCHS)
def test_dry_run_prefill_32k_records_a_census(arch):
    t = time.perf_counter()
    rec = dryrun.run_cell(arch, "prefill_32k", False)
    wall = time.perf_counter() - t
    assert rec["collectives"] is not None, rec.get("collectives_error")
    assert "collectives_error" not in rec
    assert rec["flops"] > 0 and rec["census_s"] is not None
    assert wall < CELL_TIMEOUT_S, wall
