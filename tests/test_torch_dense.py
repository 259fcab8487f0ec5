"""The last three dense architectures (qwen3-1.7b, phi3-medium-14b,
qwen2.5-32b) and the one-card bound of the launch cells.

* Each arch at its real ``n_heads``, ``n_kv_heads``, head_dim 128,
  ``rope_theta``, ``qk_norm`` and ``qkv_bias`` (GQA groups of 2, 4 and
  5), narrowed to d_model 256, d_ff 512, 2 layers and vocab 512, float32:
  the reference's ``init_params`` with ``q_norm``/``k_norm`` and
  ``bq``/``bk``/``bv`` drawn at random (the init makes them ones and
  zeros, which would hide a misplaced norm or bias), carried across by
  ``convert.params_from_reference``; prefill of 2 x 40 tokens and 3
  greedy decode steps against ``repro.models.model`` within 1e-5
  (measured at most 2.0e-6) with equal tokens, once as the packages stand and
  once with ``CHUNKED_SDPA_THRESHOLD`` at 16 in both, so that the
  prefill runs the chunked online-softmax path (decode attends over its
  whole ring in one block in both packages).
* ``init_params`` of the three full configs on ``meta`` in bfloat16 has
  exactly ``param_count()`` parameters.
* ``chip_smoke.one_card_bound`` counts the weights of the one card that
  holds them (F11): a dense cell at or above 12e9 bytes of weights is
  bounded by at least their read, a MoE decode step by the read of the
  experts its tokens reach, the cells below 12e9 bytes keep their bounds.
* ``chip_smoke.lm_dense`` (phase 28) rehearses on the CPU at the smoke
  configs.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import base as rbase
from repro.models import attention as rattn
from repro.models import model as rmodel
from repro_torch.config import base as tbase
from repro_torch.convert import params_from_reference
from repro_torch.launch import roofline
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.models.tree import tree_leaves

ROOT = pathlib.Path(__file__).resolve().parents[1]
KEY = jax.random.PRNGKey(0)
F32_TOL = 1e-5       # logits, as tests/test_torch_lm.py
TOKENS, STEPS = 40, 3
DENSE = ("qwen3-1.7b", "phi3-medium-14b", "qwen2.5-32b")
NARROW = dict(d_model=256, d_ff=512, n_layers=2, vocab_size=512,
              vocab_pad_multiple=128, remat="none", dtype="float32")
# count_params of the full configs (bfloat16 serving trees)
FULL_PARAMS = {"qwen3-1.7b": 2_038_555_648,
               "phi3-medium-14b": 14_659_507_200,
               "qwen2.5-32b": 32_779_604_992}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _narrow(arch: str):
    """The port's and the reference's config of ``arch`` at its real
    heads and head_dim, narrowed to :data:`NARROW`."""
    return (dataclasses.replace(tbase.get_config(arch), **NARROW),
            dataclasses.replace(rbase.get_config(arch), **NARROW))


def _params(cfg, rcfg, seed: int):
    """The reference's parameters with the attention's norms and biases
    drawn at random (seeded NumPy), and the port's copy of them."""
    rp = jax.tree.map(np.asarray, rmodel.init_params(rcfg, KEY))
    rng = np.random.default_rng(seed)
    attn = rp["layers"]["attn"]
    drawn = [k for k in ("q_norm", "k_norm") if cfg.qk_norm] \
        + [k for k in ("bq", "bk", "bv") if cfg.qkv_bias]
    for k in drawn:
        base = 1.0 if k.endswith("norm") else 0.0
        attn[k] = (base + 0.3 * rng.standard_normal(attn[k].shape)
                   ).astype(np.float32)
    assert set(drawn) <= set(attn) and len(drawn) == \
        2 * cfg.qk_norm + 3 * cfg.qkv_bias
    return rp, params_from_reference(cfg, rp, device="cpu")


def _counted(monkeypatch, module, calls: list):
    """``module._sdpa_chunked`` that appends to ``calls`` each time it
    runs (the reference's: each time it is traced)."""
    real = module._sdpa_chunked

    def counted(*a, **kw):
        calls.append(a[1].shape[1])
        return real(*a, **kw)
    monkeypatch.setattr(module, "_sdpa_chunked", counted)


@pytest.mark.parametrize("chunked", [False, True], ids=["dense", "chunked"])
@pytest.mark.parametrize("arch", DENSE)
def test_dense_arch_matches_reference(arch, chunked, monkeypatch):
    cfg, rcfg = _narrow(arch)
    assert cfg.resolved_head_dim == 128
    assert cfg.n_heads // cfg.n_kv_heads == {"qwen3-1.7b": 2,
                                             "phi3-medium-14b": 4,
                                             "qwen2.5-32b": 5}[arch]
    calls = {"ref": [], "port": []}
    _counted(monkeypatch, rattn, calls["ref"])
    _counted(monkeypatch, tattn, calls["port"])
    if chunked:
        monkeypatch.setattr(rattn, "CHUNKED_SDPA_THRESHOLD", 16)
        monkeypatch.setattr(tattn, "CHUNKED_SDPA_THRESHOLD", 16)
    rp, tp = _params(cfg, rcfg, seed=DENSE.index(arch))
    rp = jax.tree.map(jnp.asarray, rp)
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size,
                                               (2, TOKENS), dtype=np.int32)
    max_len = TOKENS + STEPS
    rpre = jax.jit(lambda p, b: rmodel.prefill(rcfg, p, b, max_len))
    rdec = jax.jit(lambda p, c, tk, q: rmodel.decode_step(rcfg, p, c, tk, q))
    rlog, rc, _ = rpre(rp, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        tlog, tc, _ = tmodel.prefill(
            cfg, tp, {"tokens": torch.from_numpy(tokens.astype(np.int64))},
            max_len)
        errs = [np.abs(tlog.numpy() - np.asarray(rlog)).max()]
        for i in range(STEPS):
            rtok = np.asarray(jnp.argmax(rlog[:, :cfg.vocab_size], -1))
            ttok = tlog[:, :cfg.vocab_size].argmax(-1).numpy()
            np.testing.assert_array_equal(ttok, rtok)
            pos = np.full(2, TOKENS + i, np.int32)
            rlog, rc = rdec(rp, rc, jnp.asarray(rtok), jnp.asarray(pos))
            tlog, tc = tmodel.decode_step(
                cfg, tp, tc, torch.from_numpy(ttok.astype(np.int64)),
                torch.from_numpy(pos.astype(np.int64)))
            errs.append(np.abs(tlog.numpy() - np.asarray(rlog)).max())
    print(f"{arch} {'chunked' if chunked else 'dense'}: max abs logit "
          f"error {max(errs):.2e}")
    assert max(errs) < F32_TOL, errs
    # every layer's prefill attention took the path named, in both (the
    # reference's lax.scan traces its layer once)
    assert calls["port"] == ([TOKENS] * cfg.n_layers if chunked else [])
    assert calls["ref"] == ([TOKENS] if chunked else [])


@pytest.mark.parametrize("arch", DENSE)
def test_full_config_bf16_tree_has_param_count(arch):
    cfg = tbase.get_config(arch)
    p = tmodel.init_params(cfg, device="meta", dtype=torch.bfloat16)
    leaves = tree_leaves(p)
    assert all(x.is_meta and x.dtype == torch.bfloat16 for x in leaves)
    assert sum(x.numel() for x in leaves) == cfg.param_count() \
        == FULL_PARAMS[arch]


# --------------------------------------------------------------------- #
# F11: the one-card bound counts the weights the card holds
# --------------------------------------------------------------------- #


def _bound_ms(cs, arch: str, name: str, cut: int,
              layers: int | None = None) -> tuple:
    cfg = tbase.get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return cs.one_card_bound(roofline, cfg, name, cut), cfg


def test_one_card_bound_reads_the_whole_weights():
    cs = _chip_smoke()
    bound, cfg = _bound_ms(cs, "qwen2.5-32b", "decode_32k", 1)
    assert bound["bytes"] >= 2 * cfg.param_count()
    assert bound["bound_s"] >= 2 * cfg.param_count() / 3.35e12
    assert bound["bound_s"] * 1e3 == pytest.approx(22.13, abs=0.005)


# (arch, shape, batch, layers) -> the bound in ms: the three decode cells
# of phases 25 and 26 whose weights pass the roofline's 12e9 bytes (3.98,
# 10.53, 3.62 before), and qwen1.5-0.5b's cells of phase 22, below it, as
# they were.
BOUNDS_MS = {("moonshot-v1-16b-a3b", "decode_32k", 1, None): 6.67,
             ("llava-next-mistral-7b", "decode_32k", 8, None): 14.58,
             ("deepseek-v2-236b", "decode_32k", 16, 8): 12.56,
             ("qwen1.5-0.5b", "train_4k", 2, None): 34.90,
             ("qwen1.5-0.5b", "prefill_32k", 1, None): 73.76,
             ("qwen1.5-0.5b", "decode_32k", 8, None): 8.06}


@pytest.mark.parametrize("cell", list(BOUNDS_MS), ids=lambda c: "-".join(
    str(x) for x in c if x is not None))
def test_one_card_bound_of_earlier_cells(cell):
    cs = _chip_smoke()
    bound, cfg = _bound_ms(cs, *cell)
    assert round(bound["bound_s"] * 1e3, 2) == BOUNDS_MS[cell]
    serve = cell[1] != "train_4k"
    read = cfg.active_param_count() if cfg.moe else cfg.param_count()
    assert bound["bytes"] >= (2 if serve else 32) * read


# arch -> (decode batch, layers, routed experts its tokens reach a layer)
MOE_DECODE = {"moonshot-v1-16b-a3b": (1, None, 6),
              "deepseek-v2-236b": (16, 8, 96)}


@pytest.mark.parametrize("arch", list(MOE_DECODE))
def test_one_card_bound_reads_the_experts_a_step_reaches(arch):
    """A MoE decode step reads the experts its tokens' ``top_k`` choices
    reach, not every expert; a prefill reaches them all."""
    cs = _chip_smoke()
    batch, layers, reached = MOE_DECODE[arch]
    bound, cfg = _bound_ms(cs, arch, "decode_32k", batch, layers)
    n, active = cfg.param_count(), cfg.active_param_count()
    # active_param_count keeps top_k of n_experts a MoE layer; the
    # routed experts the step cannot reach are inactive at that rate
    unread = (n - active) * (cfg.n_experts - reached) / (
        cfg.n_experts - cfg.top_k)
    assert cs.weights_read(cfg, batch) == pytest.approx(n - unread, abs=8)
    assert cs.weights_read(cfg, 1) == pytest.approx(active, abs=8)
    assert cs.weights_read(cfg, 32768) == n
    assert 2 * (n - unread) <= bound["bytes"] < 2 * n
    cache = roofline._cache_bytes(cfg, batch, 32768)
    assert bound["memory_s"] == pytest.approx(
        (2 * (n - unread) + cache + batch * cfg.d_model * cfg.n_layers * 2)
        / roofline.HBM_BW, rel=1e-6)


# --------------------------------------------------------------------- #
# Phase 28 of chip_smoke.py, rehearsed on the CPU
# --------------------------------------------------------------------- #


def test_chip_smoke_phase_28_rehearses_on_the_cpu():
    cs = _chip_smoke()
    from repro_torch.kernels import _build
    out = cs.lm_dense("cpu", _build, cs.SEED)
    assert cs.DENSE_ARCHS == DENSE
    for arch in DENSE:
        cells = out[arch]["cells"]
        assert sorted(k for k in cells if not k.endswith("_profile")) == \
            ["decode_32k", "prefill_32k", "train_4k"]
        assert out[arch]["f32_err"] <= cs.SERVE_F32_TOL
        assert len(out[arch]["serve"]) == 3
    assert set(out["launches"]) == {"bit_transpose32", "run_program_cuda"}
