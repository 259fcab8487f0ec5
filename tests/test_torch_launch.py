"""The launch and distributed slice of the port against the reference.

* every test of ``tests/distributed/test_launch_units.py`` and
  ``tests/launch/test_roofline.py`` through both packages (the ``PKG``
  fixture), the port's roofline under the reference's TPU v5e constants
  (``PEAK_FLOPS``, ``HBM_BW``, ``ICI_BW`` monkeypatched, as
  ``tests/test_torch_autotune.py`` does for the cost model); the H100
  constants pinned apart;
* ``input_specs`` of all 32 cells: the reference's tree paths, shapes and
  dtypes;
* the sharding specs of every leaf (params, ``mu``/``nu``, batch, caches)
  of all 10 archs at full width, every cell, on the 16x16 and 2x16x16
  production meshes (the reference's on ``jax.sharding.AbstractMesh``);
* ``build_cell`` on the qwen3-1.7b, deepseek-v2-236b and mamba2-130m smoke
  configs: the port's ``cell.fn`` on the CPU equals the reference's within
  1e-5 in float32;
* the analytic dry run (argument bytes, records through ``dryrun_table``
  and ``roofline.analyze_record``, a failing cell's record), meshes,
  ``local_shape``, the MoE dispatch traced on ``meta``, and the
  ``hypothesis`` fallback's draws.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import math
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.train.optimizer import adamw_init as ref_adamw_init
from repro_torch.convert import params_from_reference
from repro_torch.models.tree import tree_items, tree_map_with_path
from repro_torch.train.optimizer import adamw_init

PACKAGES = ["repro", "repro_torch"]
REF_ANCHORS = {"PEAK_FLOPS": 197e12, "HBM_BW": 819e9, "ICI_BW": 50e9}
F32_TOL = 1e-5


def _ns(name: str) -> types.SimpleNamespace:
    # The reference's dryrun module appends a 512-host-device flag to
    # XLA_FLAGS when it is imported: start JAX's backend first and put the
    # variable back, so neither this process nor its children see it.
    jax.devices()
    flags = os.environ.get("XLA_FLAGS")
    ns = types.SimpleNamespace(name=name)
    for attr, mod in (("base", "config.base"), ("roofline", "launch.roofline"),
                      ("dryrun", "launch.dryrun"), ("steps", "launch.steps"),
                      ("sharding", "distributed.sharding"),
                      ("mesh", "launch.mesh"), ("model", "models.model"),
                      ("testing", "testing")):
        setattr(ns, attr, importlib.import_module(f"{name}.{mod}"))
    if flags is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = flags
    return ns


NS = {name: _ns(name) for name in PACKAGES}
R, T = NS["repro"], NS["repro_torch"]


@pytest.fixture(params=PACKAGES)
def PKG(request, monkeypatch):
    """One package; the port's roofline under the reference's anchors."""
    ns = NS[request.param]
    if ns is T:
        for k, v in REF_ANCHORS.items():
            monkeypatch.setattr(T.roofline, k, v)
    return ns


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test's torch CPU ops on one thread (see test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _is_spec(ns, leaf) -> bool:
    if ns is R:
        return isinstance(leaf, jax.ShapeDtypeStruct)
    return isinstance(leaf, torch.Tensor) and leaf.device.type == "meta"


def _leaves(ns, tree) -> list:
    if ns is R:
        return jax.tree.leaves(tree)
    return [leaf for _, leaf in tree_items(tree)]


def _key(p) -> str:
    return str(getattr(p, "key", getattr(p, "idx", p)))


def _ref_flat(tree) -> dict:
    return {tuple(_key(p) for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_flat(tree) -> dict:
    return {tuple(str(k) for k in path): leaf
            for path, leaf in tree_items(tree)}


# --------------------------------------------------------------------- #
# tests/distributed/test_launch_units.py through both packages
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", R.base.ARCH_IDS)
def test_input_specs_exist_for_all_cells(PKG, arch):
    """Shape-only stand-ins for every model input, no device allocation."""
    for sname, shape in PKG.base.shapes_for(arch).items():
        spec = PKG.steps.input_specs(arch, shape)
        assert "params" in spec
        leaves = _leaves(PKG, spec)
        assert all(_is_spec(PKG, leaf) for leaf in leaves)
        if shape.kind == "train":
            tok = spec["batch"]["tokens"].dtype
            assert tok == (np.int32 if PKG is R else torch.int32)
        if shape.kind == "decode":
            assert tuple(spec["token"].shape) == (shape.global_batch,)
            assert len(_leaves(PKG, spec["caches"])) > 0


def test_shape_grid_skips(PKG):
    """long_500k only for sub-quadratic archs."""
    shapes_for = PKG.base.shapes_for
    assert "long_500k" in shapes_for("hymba-1.5b")
    assert "long_500k" in shapes_for("mamba2-130m")
    for arch in ("qwen2.5-32b", "deepseek-v2-236b", "llava-next-mistral-7b"):
        assert "long_500k" not in shapes_for(arch)
    # 32 total runnable cells: 10 archs x (train+prefill+decode) + 2 long.
    assert sum(len(shapes_for(a)) for a in PKG.base.ARCH_IDS) == 32


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "deepseek-v2-236b",
                                  "mamba2-130m", "hymba-1.5b"])
def test_analytic_flops_sane(PKG, arch):
    """Analytic FLOPs >= classic 6ND/2ND estimators (they add attention
    context + MoE capacity + remat), within a sane factor."""
    for sname in PKG.base.shapes_for(arch):
        af = PKG.roofline.analytic_flops(arch, sname)
        mf = PKG.roofline.model_flops(arch, sname)
        assert af > 0 and mf > 0
        assert 0.5 < af / mf < 20, f"{arch}/{sname}: {af/mf}"
        assert af == R.roofline.analytic_flops(arch, sname)
        assert mf == R.roofline.model_flops(arch, sname)


def test_analytic_bytes_positive(PKG):
    for arch in ("qwen2.5-32b", "moonshot-v1-16b-a3b"):
        for sname in PKG.base.shapes_for(arch):
            got = PKG.roofline.analytic_bytes_per_chip(arch, sname, 256)
            assert got > 0
            assert got == R.roofline.analytic_bytes_per_chip(arch, sname,
                                                             256)


def test_loop_trip_counts(PKG):
    loop_trip = PKG.roofline.loop_trip
    assert loop_trip("qwen2.5-32b", "train_4k") == 64
    assert loop_trip("deepseek-v2-236b", "train_4k") == 59  # 1 dense layer
    assert loop_trip("hymba-1.5b", "prefill_32k") == 32     # kv-block scan
    assert loop_trip("qwen3-1.7b", "decode_32k") == 28      # scanned decode


HLO = """
ENTRY %main (p0: f32[8,128]) -> f32[8,128] {
  %ag = f32[8,128]{1,0} all-gather(%p0), replica_groups={}
  %t = (f32[8,128]) tuple(%ag)
}
%region_0.1 (arg: (s32[], f32[4,64])) -> (s32[], f32[4,64]) {
  %ar = f32[4,64]{1,0} all-reduce(%x), to_apply=%sum
}
"""


def test_parse_collective_bytes_regions(PKG):
    out = PKG.dryrun.parse_collective_bytes(HLO)
    assert out["all-gather"] == 8 * 128 * 4
    assert out["all-reduce"] == 4 * 64 * 4
    # AR weighted x2, and it sits in a loop region.
    assert out["region_weighted"] == 2 * 4 * 64 * 4
    assert out["total_weighted"] == 8 * 128 * 4 + 2 * 4 * 64 * 4
    assert out == R.dryrun.parse_collective_bytes(HLO)


def test_analyze_record_dominant_terms(PKG):
    rec = {"arch": "qwen3-1.7b", "shape": "train_4k", "mesh": "16x16",
           "n_devices": 256, "flops": 1e12, "bytes_accessed": 1e9,
           "collectives": {"total_weighted": 1e9, "region_weighted": 5e8},
           "status": "ok"}
    p = PKG.roofline.analyze_record(rec)
    assert p.dominant in ("compute", "memory", "collective")
    assert p.compute_s > 0 and p.collective_s > 0
    assert 0 < p.roofline_fraction <= 1.5
    # region bytes get multiplied by the layer trip count (28).
    assert p.collective_s * 50e9 == pytest.approx(5e8 + 5e8 * 28)
    assert dataclasses.asdict(p) == dataclasses.asdict(
        R.roofline.analyze_record(rec))


# --------------------------------------------------------------------- #
# tests/launch/test_roofline.py through both packages
# --------------------------------------------------------------------- #

ARCH = "qwen1.5-0.5b"  # dense GQA, no windows -> fully hand-computable


def test_attn_flops_gqa_closed_form(PKG):
    cfg = PKG.base.get_config(ARCH)
    d, h, hkv, dh = 1024, 16, 16, 64
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim) == (d, h, hkv, dh)
    proj = 2 * d * dh * (h + 2 * hkv) + 2 * h * dh * d
    assert proj == 8_388_608
    for ctx in (0.0, 2048.0):
        expected = proj + 4 * ctx * h * dh
        assert PKG.roofline._attn_flops_per_token(cfg, ctx) == expected


def test_ffn_flops_dense_closed_form(PKG):
    cfg = PKG.base.get_config(ARCH)
    assert cfg.d_ff == 2816 and not cfg.moe
    assert PKG.roofline._ffn_flops_per_token(cfg) == 6 * 1024 * 2816 \
        == 17_301_504


def test_layer_flops_is_attn_plus_ffn(PKG):
    cfg, rl = PKG.base.get_config(ARCH), PKG.roofline
    ctx = 4096.0 / 2
    expected = rl._attn_flops_per_token(cfg, ctx) + \
        rl._ffn_flops_per_token(cfg)
    assert rl._layer_flops_per_token(cfg, 0, ctx) == expected
    # All 24 layers identical (no sliding windows on this arch).
    assert rl._layer_flops_per_token(cfg, 23, ctx) == expected


def test_analytic_flops_train_assembly(PKG):
    cfg, rl = PKG.base.get_config(ARCH), PKG.roofline
    shape = PKG.base.LM_SHAPES["train_4k"]
    tokens = shape.global_batch * shape.seq_len
    per_tok = 24 * (rl._attn_flops_per_token(cfg, shape.seq_len / 2)
                    + rl._ffn_flops_per_token(cfg))
    assert cfg.remat == "full"
    head = 2 * cfg.d_model * cfg.padded_vocab * tokens * 3.0
    assert rl.analytic_flops(ARCH, "train_4k") == per_tok * tokens * 4.0 \
        + head


def test_analytic_flops_decode_assembly(PKG):
    cfg, rl = PKG.base.get_config(ARCH), PKG.roofline
    shape = PKG.base.LM_SHAPES["decode_32k"]
    tokens = shape.global_batch
    per_tok = 24 * (rl._attn_flops_per_token(cfg, float(shape.seq_len))
                    + rl._ffn_flops_per_token(cfg))
    head = 2 * cfg.d_model * cfg.padded_vocab * tokens
    assert rl.analytic_flops(ARCH, "decode_32k") == per_tok * tokens + head


def test_model_flops_classic_estimators(PKG):
    n = PKG.base.get_config(ARCH).param_count()
    mf = PKG.roofline.model_flops
    assert mf(ARCH, "train_4k") == 6.0 * n * 256 * 4096
    assert mf(ARCH, "prefill_32k") == 2.0 * n * 32 * 32768
    assert mf(ARCH, "decode_32k") == 2.0 * n * 128


def test_loop_trip_scanned_layers(PKG):
    cfg = PKG.base.get_config(ARCH)
    n_scan = cfg.n_layers - cfg.first_dense_layers
    assert n_scan == 24
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        assert PKG.roofline.loop_trip(ARCH, shape) == n_scan


def test_analyze_record_term_assembly(PKG):
    rl = PKG.roofline
    rec = {
        "arch": ARCH, "shape": "decode_32k", "mesh": "2x16x16",
        "n_devices": 512, "flops": 1.0e15,
        "collectives": {"total_weighted": 9.0e9, "region_weighted": 4.0e9},
    }
    p = rl.analyze_record(rec)
    assert p.compute_s == rl.analytic_flops(ARCH, "decode_32k") / (
        512 * rl.PEAK_FLOPS)
    # region bytes replayed once per scanned layer, main bytes once
    assert p.collective_s == (5.0e9 + 4.0e9 * 24) / rl.ICI_BW
    assert p.hlo_flops_raw == 1.0e15
    assert p.model_flops == rl.model_flops(ARCH, "decode_32k")
    assert p.memory_s > 0
    assert dataclasses.asdict(p) == dataclasses.asdict(
        R.roofline.analyze_record(rec))


def test_roofline_point_derived_properties(PKG):
    rl = PKG.roofline
    p = rl.RooflinePoint(arch="x", shape="y", mesh="2x16x16",
                         compute_s=2e-3, memory_s=5e-3, collective_s=1e-3,
                         model_flops=512 * rl.PEAK_FLOPS * 1e-3,
                         analytic_flops_total=512 * rl.PEAK_FLOPS * 4e-3,
                         hlo_flops_raw=-1.0)
    assert p.dominant == "memory"
    assert p.bound_s == 5e-3
    assert p.useful_ratio == pytest.approx(0.25)
    # useful_s = model_flops/(512*PEAK) = 1e-3; fraction = 1e-3 / 5e-3
    assert p.roofline_fraction == pytest.approx(0.2)


def test_markdown_table_shape(PKG):
    rl = PKG.roofline
    p = rl.RooflinePoint(arch="a", shape="s", mesh="m", compute_s=1e-3,
                         memory_s=2e-3, collective_s=3e-3, model_flops=1e12,
                         analytic_flops_total=2e12, hlo_flops_raw=1e12)
    failed = rl.RooflinePoint(arch="b", shape="s", mesh="m", compute_s=0,
                              memory_s=0, collective_s=0, model_flops=0,
                              analytic_flops_total=0, hlo_flops_raw=-1,
                              status="compile_error")
    md = rl.to_markdown([p, failed])
    lines = md.splitlines()
    assert lines[0].startswith("| arch |") and len(lines) == 4
    assert "collective" in lines[2] and "FAILED" in lines[3]
    assert md == R.roofline.to_markdown([
        R.roofline.RooflinePoint(**dataclasses.asdict(q))
        for q in (p, failed)])


def test_autotune_cost_model_anchors_to_roofline_constants():
    """Each package's autotune cost model derives its host-side rates from
    its roofline's constants; the port imports them from its roofline."""
    from repro.autotune.cost import HOST_BW, HOST_WORD_RATE
    from repro_torch.autotune import cost
    assert HOST_BW == R.roofline.HBM_BW / 16
    assert HOST_WORD_RATE == R.roofline.PEAK_FLOPS / 1e5
    assert (cost.HBM_BW, cost.PEAK_FLOPS) == (T.roofline.HBM_BW,
                                              T.roofline.PEAK_FLOPS)
    assert cost.host_anchors() == (T.roofline.HBM_BW / 16,
                                   T.roofline.PEAK_FLOPS / 1e5)
    assert cost.BACKEND_SPEED["shard-words"] == (1.6, 1.6)


def test_roofline_constants_are_the_h100s():
    """H100 80GB HBM3 SXM at 700 W: bf16 dense peak, device memory rate,
    one 400 Gb/s NDR port per card; the terms use them."""
    rl = T.roofline
    assert (rl.PEAK_FLOPS, rl.HBM_BW, rl.ICI_BW) == (989.4e12, 3.35e12, 50e9)
    rec = {"arch": ARCH, "shape": "train_4k", "mesh": "16x16",
           "n_devices": 256, "flops": 1.0,
           "collectives": {"total_weighted": 2e9, "region_weighted": 0.0}}
    p = rl.analyze_record(rec)
    assert p.compute_s == rl.analytic_flops(ARCH, "train_4k") / (
        256 * 989.4e12)
    assert p.memory_s == rl.analytic_bytes_per_chip(ARCH, "train_4k",
                                                    256) / 3.35e12
    assert p.collective_s == 2e9 / 50e9
    # The reference's own terms stay on its TPU v5e constants.
    assert (R.roofline.PEAK_FLOPS, R.roofline.HBM_BW) == (197e12, 819e9)


# --------------------------------------------------------------------- #
# input_specs: the reference's tree paths, shapes and dtypes
# --------------------------------------------------------------------- #


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


@pytest.mark.parametrize("arch", R.base.ARCH_IDS)
def test_input_specs_match_reference(arch):
    for sname, shape in R.base.shapes_for(arch).items():
        want = {path: (tuple(x.shape), _dtype_name(x.dtype)) for path, x in
                _ref_flat(R.steps.input_specs(arch, shape)).items()}
        got = {path: (tuple(x.shape), _dtype_name(x.dtype)) for path, x in
               _port_flat(T.steps.input_specs(arch, shape)).items()}
        assert got == want, (arch, sname)


# --------------------------------------------------------------------- #
# Sharding specs: every leaf of every cell, both production meshes
# --------------------------------------------------------------------- #

CELLS = [(arch, sname) for arch in R.base.ARCH_IDS
         for sname in R.base.shapes_for(arch)]


def _ref_specs(tree) -> dict:
    return {path: tuple(s.spec) for path, s in _ref_flat(tree).items()}


def _port_specs(tree) -> dict:
    return {path: tuple(s.spec) for path, s in _port_flat(tree).items()}


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch,sname", CELLS)
def test_cell_shardings_match_reference(arch, sname, multi_pod):
    shape = R.base.LM_SHAPES[sname]
    if multi_pod:
        amesh = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    else:
        amesh = AbstractMesh((16, 16), ("data", "model"))
    mesh = T.mesh.make_production_mesh(multi_pod=multi_pod)
    assert mesh.shape == dict(amesh.shape) and mesh.size == amesh.size
    rcell = R.steps.build_cell(arch, shape, amesh)
    tcell = T.steps.build_cell(arch, shape, mesh)
    for attr in ("in_shardings", "out_shardings"):
        want = _ref_specs(getattr(rcell, attr))
        got = _port_specs(getattr(tcell, attr))
        assert got == want, (arch, sname, attr,
                             {k: (got.get(k), want.get(k))
                              for k in set(got) | set(want)
                              if got.get(k) != want.get(k)})
    assert tcell.donate_argnums == rcell.donate_argnums
    # The memory tiers: FSDP where the reference's rules put it.
    if shape.kind == "train" and arch in ("qwen2.5-32b", "deepseek-v2-236b"):
        nu = _port_specs(tcell.in_shardings[1]["nu"])
        assert any("data" in str(spec) for spec in nu.values())


def test_param_pspec_rules_match_reference():
    """The rule table leaf by leaf for qwen1.5-0.5b, and its FSDP and
    multi-axis data entries."""
    cfg_r, cfg_t = R.base.get_config(ARCH), T.base.get_config(ARCH)
    assert tuple(R.sharding.param_pspec(
        cfg_r, "embed/embedding", (151936, 1024), 16)) == ("model", None)
    for args in [("embed/embedding", (153600, 1024), 16, 16, True,
                  ("pod", "data")),
                 ("layers/attn/wq", (24, 1024, 16, 64), 16, 16, True),
                 ("layers/attn/wo", (24, 16, 64, 1024), 16),
                 ("layers/mlp/w_down", (24, 2816, 1024), 16, 32, True),
                 ("layers/moe/w_up", (24, 64, 1024, 1408), 16, 16, True),
                 ("layers/ssm/in_proj", (24, 768, 3352), 16, 16, True),
                 ("final_norm/scale", (1024,), 16)]:
        assert tuple(T.sharding.param_pspec(cfg_t, *args)) == tuple(
            R.sharding.param_pspec(cfg_r, *args)), args


def test_local_shape():
    mesh = T.mesh.Mesh(("pod", "data", "model"), (2, 4, 8))
    P = T.sharding.P
    assert T.sharding.local_shape((16, 64, 3), P(("pod", "data"), "model"),
                                  mesh) == (2, 8, 3)
    assert T.sharding.local_shape((16, 64), P(), mesh) == (16, 64)
    assert T.sharding.local_shape((10,), P("model"), mesh) == (2,)  # pads


# --------------------------------------------------------------------- #
# Meshes
# --------------------------------------------------------------------- #


def test_meshes():
    m = T.mesh.make_production_mesh()
    assert (m.axis_names, m.shape, m.size, m.devices) == (
        ("data", "model"), {"data": 16, "model": 16}, 256, None)
    m2 = T.mesh.make_production_mesh(multi_pod=True)
    assert m2.shape == {"pod": 2, "data": 16, "model": 16}
    assert T.mesh.data_axes(m2) == ("pod", "data")
    assert T.mesh.model_axis_size(m2) == 16
    assert T.sharding.batch_pspec(m2) == T.sharding.P(("pod", "data"))
    cpu = torch.device("cpu")
    t4 = T.mesh.make_test_mesh(devices=[cpu] * 4)
    assert t4.shape == {"data": 2, "model": 2} and t4.devices == (cpu,) * 4
    assert T.mesh.make_test_mesh(3, devices=[cpu] * 4).shape == {
        "data": 3, "model": 1}
    with pytest.raises(ValueError):
        T.mesh.make_test_mesh(5, devices=[cpu] * 4)
    if torch.cuda.is_available():
        assert T.mesh.make_test_mesh().devices[0].type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            T.mesh.make_test_mesh()
        with pytest.raises(RuntimeError, match="no CUDA card"):
            T.sharding.words_mesh()
    w = T.sharding.words_mesh([cpu] * 3)
    assert w.shape == {"words": 3}
    assert T.sharding.words_sharding(w).spec == T.sharding.P("words")


# --------------------------------------------------------------------- #
# build_cell: the port's cell.fn against the reference's
# --------------------------------------------------------------------- #

SMOKE_ARCHS = ["qwen3-1.7b", "deepseek-v2-236b", "mamba2-130m"]
TINY = {"train": ("train_tiny", "train", 16, 4),
        "prefill": ("prefill_tiny", "prefill", 16, 2),
        "decode": ("decode_tiny", "decode", 16, 2)}


def _smoke(monkeypatch, arch, dtype="float32"):
    """Both packages' build_cell resolve ``arch`` to its smoke config in
    ``dtype`` (``None``: its own), as tests/distributed/
    test_multidevice.py:91 patches it."""
    rcfg, tcfg = R.base.get_smoke_config(arch), T.base.get_smoke_config(arch)
    if dtype is not None:
        rcfg = dataclasses.replace(rcfg, dtype=dtype)
        tcfg = dataclasses.replace(tcfg, dtype=dtype)
    monkeypatch.setattr(R.steps, "get_config", lambda a: rcfg)
    monkeypatch.setattr(T.steps, "get_config", lambda a: tcfg)
    return rcfg, tcfg


def _port_like(ref_tree, port_tree):
    """``ref_tree``'s arrays as tensors laid out as ``port_tree``."""
    flat = {path: np.asarray(x) for path, x in _ref_flat(ref_tree).items()}
    return tree_map_with_path(
        lambda path, leaf: torch.from_numpy(
            flat[tuple(path.split("/"))].copy()), port_tree)


def _max_err(got, want) -> float:
    g, w = _port_flat(got), _ref_flat(want)
    assert sorted(g) == sorted(w)
    return max(float(np.abs(g[k].detach().float().numpy()
                            - np.asarray(w[k], np.float32)).max())
               for k in g)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_build_cell_matches_reference(monkeypatch, arch, kind):
    rcfg, tcfg = _smoke(monkeypatch, arch)
    rshape = R.base.ShapeConfig(*TINY[kind])
    tshape = T.base.ShapeConfig(*TINY[kind])
    rmesh = AbstractMesh((1, 1), ("data", "model"))
    tmesh = T.mesh.make_test_mesh(devices=["cpu"])
    rcell = R.steps.build_cell(arch, rshape, rmesh)
    tcell = T.steps.build_cell(arch, tshape, tmesh)
    assert tcell.donate_argnums == rcell.donate_argnums
    rparams = R.model.init_params(rcfg, jax.random.PRNGKey(0))
    tparams = params_from_reference(tcfg, jax.tree.map(np.asarray, rparams),
                                    device="cpu")
    rng = np.random.default_rng(7)
    b, s = rshape.global_batch, rshape.seq_len
    if kind == "train":
        tokens = rng.integers(0, rcfg.vocab_size, (b, s + 1), np.int32)
        _, _, rm = jax.jit(rcell.fn)(rparams, ref_adamw_init(rparams),
                                     {"tokens": jnp.asarray(tokens)})
        _, _, tm = tcell.fn(tparams, adamw_init(tparams),
                            {"tokens": torch.from_numpy(tokens)})
        assert sorted(tm) == sorted(rm)
        for k in rm:
            rel = abs(float(tm[k]) - float(rm[k])) / max(abs(float(rm[k])),
                                                         1e-30)
            assert rel <= F32_TOL, (k, float(tm[k]), float(rm[k]))
        return
    if kind == "prefill":
        tokens = rng.integers(0, rcfg.vocab_size, (b, s), np.int32)
        rout = jax.jit(rcell.fn)(rparams, {"tokens": jnp.asarray(tokens)})
        tout = tcell.fn(tparams, {"tokens": torch.from_numpy(tokens)})
        assert rout[2] is None and tout[2] is None
        assert _max_err(tout[:2], rout[:2]) < F32_TOL
        return
    rcache = jax.tree.map(
        lambda x: jnp.asarray(rng.normal(0, 1, x.shape), jnp.float32),
        R.model.init_cache(rcfg, b, s, jnp.float32))
    tcache = _port_like(rcache, T.model.init_cache(tcfg, b, s, torch.float32,
                                                   device="cpu"))
    tok = rng.integers(0, rcfg.vocab_size, (b,), np.int32)
    pos = np.array([5, 11], np.int32)
    rout = jax.jit(rcell.fn)(rparams, rcache, jnp.asarray(tok),
                             jnp.asarray(pos))
    tout = tcell.fn(tparams, tcache, torch.from_numpy(tok),
                    torch.from_numpy(pos))
    assert _max_err(tout, rout) < F32_TOL


def test_serve_seq_parallel_changes_no_number(monkeypatch):
    """A small model's serving cell turns ``serve_seq_parallel`` on (the
    reference's memory tier); in one process its constraints are
    identities, so the cell's outputs equal the plain prefill's."""
    _, tcfg = _smoke(monkeypatch, "qwen3-1.7b")
    shape = T.base.ShapeConfig("prefill_tiny", "prefill", 16, 2)
    cell = T.steps.build_cell("qwen3-1.7b", shape,
                              T.mesh.make_test_mesh(devices=["cpu"]))
    params = T.model.init_params(tcfg, 0, device="cpu")
    batch = {"tokens": torch.from_numpy(np.random.default_rng(3).integers(
        0, tcfg.vocab_size, (2, 16), np.int32))}
    got = cell.fn(params, batch)
    assert not tcfg.serve_seq_parallel
    want = T.model.prefill(tcfg, params, batch, 16)
    assert torch.equal(got[0], want[0])
    for (_, g), (_, w) in zip(tree_items(got[1]), tree_items(want[1])):
        assert torch.equal(g, w)


# --------------------------------------------------------------------- #
# The analytic dry run
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("sname,multi_pod", [("train_4k", False),
                                             ("decode_32k", True)])
def test_dry_run_record(monkeypatch, tmp_path, sname, multi_pod):
    """A smoke-patched cell on a production mesh: its argument bytes are
    the sum over ``local_shape``, its FLOPs those of the trace over
    ``n_devices``, its collective census (a DTensor trace over the mesh)
    in the reference's schema with every layer traced (no loop-body
    bucket), and the record renders through ``dryrun_table`` and
    ``roofline.analyze_record`` (a collective term on the train cell)."""
    _smoke(monkeypatch, "qwen3-1.7b", dtype=None)
    rec = T.dryrun.run_cell("qwen3-1.7b", sname, multi_pod)
    mesh = T.mesh.make_production_mesh(multi_pod=multi_pod)
    assert rec["mesh"] == ("2x16x16" if multi_pod else "16x16")
    assert rec["n_devices"] == mesh.size
    cell = T.steps.build_cell("qwen3-1.7b", T.base.LM_SHAPES[sname], mesh)
    want = 0
    for (_, x), (_, sh) in zip(tree_items(cell.args),
                               tree_items(cell.in_shardings)):
        want += math.prod(T.sharding.local_shape(x.shape, sh.spec, mesh)) \
            * x.element_size()
    assert rec["memory"]["argument_size_in_bytes"] == want > 0
    assert rec["flops"] > 0 and rec["lower_compile_s"] >= 0
    for k in ("bytes_accessed", "transcendentals", "hlo_bytes"):
        assert rec[k] is None
    assert rec["memory"]["temp_size_in_bytes"] is None
    coll = rec["collectives"]
    assert coll is not None and coll["region_weighted"] == 0
    kinds = {k: v for k, v in coll.items() if k in T.dryrun.COLLECTIVE_FACTOR}
    assert kinds and coll["total_weighted"] == sum(
        T.dryrun.COLLECTIVE_FACTOR[k] * v for k, v in kinds.items())
    rec["status"] = "ok"
    path = tmp_path / "dry.jsonl"
    path.write_text(json.dumps(rec) + "\n")
    from repro_torch.launch import dryrun_table
    dryrun_table.main([str(path)])
    p = T.roofline.analyze_record(rec)
    assert p.compute_s > 0 and p.memory_s > 0
    assert p.collective_s == coll["total_weighted"] / T.roofline.ICI_BW
    if sname == "train_4k":
        assert p.collective_s > 0
    assert p.hlo_flops_raw == rec["flops"]
    assert "qwen3-1.7b" in T.roofline.to_markdown([p])


def test_census_counts_the_all_reduce_of_sharded_contractions(monkeypatch):
    """A float32 smoke train cell (32 x 16) on the 16x16 mesh over the
    ``fake`` backend: each layer's attention output projection contracts
    heads sharded over ``model``, a partial sum DTensor all-reduces; the
    census counts at least one [1, 32, d_model] float32 sum a layer."""
    _, tcfg = _smoke(monkeypatch, "qwen3-1.7b")
    mesh = T.mesh.make_production_mesh()
    cell = T.steps.build_cell("qwen3-1.7b",
                              T.base.ShapeConfig("train_tiny", "train", 32,
                                                 16), mesh)
    coll = T.dryrun.collective_census(cell, mesh)
    assert coll["region_weighted"] == 0.0
    assert coll["all-reduce"] >= tcfg.n_layers * 32 * tcfg.d_model * 4
    import torch.distributed as dist
    assert not dist.is_initialized()       # the fake group is torn down


def test_dry_run_failing_census_keeps_the_cell(monkeypatch):
    """A DTensor trace that fails leaves ``collectives`` null, names the
    failing op, and keeps the cell ``ok``."""
    def broken(cell, mesh):
        raise RuntimeError("Sharding propagation failed for aten.view")

    monkeypatch.setattr(T.dryrun, "collective_census", broken)
    _smoke(monkeypatch, "qwen3-1.7b", dtype=None)
    rec = T.dryrun.run_cell("qwen3-1.7b", "decode_32k", False)
    assert rec["collectives"] is None and rec["flops"] > 0
    assert "aten.view" in rec["collectives_error"]
    assert T.roofline.analyze_record(rec).collective_s == 0.0


def test_dry_run_failing_cell_records_its_error(monkeypatch, tmp_path,
                                                capsys):
    def broken(*a, **kw):
        raise RuntimeError("no such layout")

    monkeypatch.setattr(T.dryrun, "build_cell", broken)
    out = tmp_path / "dry.jsonl"
    rec = T.dryrun._run_one_inline("qwen1.5-0.5b", "train_4k", False,
                                   str(out))
    assert rec["status"] == "fail"
    assert rec["error"] == "RuntimeError: no such layout"
    assert json.loads(out.read_text())["status"] == "fail"
    assert "[dryrun] FAIL" in capsys.readouterr().out
    from repro_torch.launch import dryrun_table
    dryrun_table.main([str(out)])
    assert "FAIL: RuntimeError" in capsys.readouterr().out


def test_dry_run_traces_qwen_train_at_full_width():
    """qwen1.5-0.5b's train cell at full width on 16x16: the counted
    matmul FLOPs per device over the analytic model's (which counts
    half the causal attention and no embedding gather)."""
    rec = T.dryrun.run_cell(ARCH, "train_4k", False)
    total = rec["flops"] * rec["n_devices"]
    af = T.roofline.analytic_flops(ARCH, "train_4k")
    assert 1.0 < total / af < 1.3
    # Params and both moments float32, tokens int32; 623M params under
    # TP 16 (vocab and heads split), the batch over 16 data shards.
    assert rec["memory"]["argument_size_in_bytes"] < 3 * 4 * 623e6 / 8


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "deepseek-v2-236b"])
def test_moe_dispatch_traces_on_meta(arch):
    """The MoE dispatch counts experts with ``index_add_`` (no host sync,
    a meta kernel), so the dry run traces the MoE archs."""
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.model import layer_slice
    cfg = T.base.get_smoke_config(arch)
    params = T.model.init_params(cfg, device="meta")
    p = layer_slice(params["layers"], 0)["moe"]
    x = torch.empty((2, 8, cfg.d_model), device="meta")
    y, aux = moe_mod.moe_ffn(cfg, p, x)
    assert y.device.type == "meta" and tuple(y.shape) == (2, 8, cfg.d_model)
    assert set(aux) == {"load_balance_loss", "z_loss"}


# --------------------------------------------------------------------- #
# The hypothesis fallback
# --------------------------------------------------------------------- #


def test_testing_fallback_draws_equal_reference():
    draws = {}
    for ns in (R, T):
        got = draws[ns.name] = []
        st = ns.testing.st

        @ns.testing.settings(max_examples=40)
        @ns.testing.given(a=st.integers(0, 1 << 20),
                          b=st.sampled_from(["x", "y", "z"]))
        def body(a, b):
            got.append((a, b))

        body()
    assert len(draws["repro_torch"]) == 25  # capped at _MAX_EXAMPLES
    assert draws["repro_torch"] == draws["repro"]
