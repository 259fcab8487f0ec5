"""The configuration files hold the published keys, and BENCHMARK.json
keeps to the shape of the benchmark's contract."""

import json
import re

import pytest

from perfbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

PUBLISHED = {
    "qwen3-1.7b": {
        "hidden_size": 2048, "num_attention_heads": 16,
        "num_key_value_heads": 8, "head_dim": 128,
        "intermediate_size": 6144, "num_hidden_layers": 28,
        "vocab_size": 151936, "tie_word_embeddings": True,
        "rope_theta": 1000000, "rms_norm_eps": 1e-06,
        "max_position_embeddings": 40960, "attention_bias": False,
        "model_type": "qwen3", "hidden_act": "silu",
        "eos_token_id": 151645, "bos_token_id": 151643},
    "qwen2.5-32b": {
        "hidden_size": 5120, "num_attention_heads": 40,
        "num_key_value_heads": 8, "intermediate_size": 27648,
        "num_hidden_layers": 64, "vocab_size": 152064,
        "tie_word_embeddings": False, "rope_theta": 1000000.0,
        "max_position_embeddings": 32768, "model_type": "qwen2",
        "hidden_act": "silu", "eos_token_id": 151645,
        "bos_token_id": 151643, "use_sliding_window": False},
}


@pytest.mark.parametrize("name", sorted(PUBLISHED))
def test_config_holds_published_keys(name):
    conf = spec.load_json(spec.HERE / "configs" / f"{name}.json")
    for k, v in PUBLISHED[name].items():
        assert conf[k] == v, k


def test_qwen25_unconfirmed_values_are_assumed():
    conf = spec.load_json(spec.HERE / "configs" / "qwen2.5-32b.json")
    assert {"rms_norm_eps", "max_window_layers"} <= set(conf["assumed"])
    assert spec.arch(conf)["eps"] == conf["assumed"]["rms_norm_eps"]


@pytest.mark.parametrize("name", sorted(PUBLISHED))
def test_port_config_is_as_published(name):
    conf = spec.load_json(spec.HERE / "configs" / f"{name}.json")
    cfg = spec.port_config(conf, name)
    a = spec.arch(conf)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size) == (
        a["layers"], a["d"], a["heads"], a["kv_heads"], a["head_dim"],
        a["d_ff"], a["vocab"])
    assert cfg.tie_embeddings == conf["tie_word_embeddings"]
    assert cfg.qk_norm == (conf["model_type"] == "qwen3")
    assert cfg.qkv_bias == (conf["model_type"] == "qwen2")


def test_parameter_counts():
    from repro_torch.models.model import count_params
    q3 = spec.port_config(spec.load_json(spec.HERE / "configs" /
                                         "qwen3-1.7b.json"), "q3")
    q25 = spec.port_config(spec.load_json(spec.HERE / "configs" /
                                          "qwen2.5-32b.json"), "q25")
    # padded vocabularies of 153,600 rows
    assert count_params(q3) == pytest.approx(1.724e9, rel=1e-3)
    assert count_params(q25) * 2 / 2 ** 30 == pytest.approx(61.06, rel=1e-3)


def _bench():
    return spec.benchmark()


def test_benchmark_shape():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["perfbench"]
    assert 1 <= b["run_seconds"] <= 51
    assert (spec.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    names = [c["name"] for c in b["configs"]] + [w["name"] for w in
                                                 b["workloads"]]
    names += [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/") and c["reduced"] == []
        assert (spec.ROOT / c["file"]).is_file()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (spec.HERE / "workloads" / f"{w['name']}.json").is_file()
        assert (spec.HERE / "traffic" / f"{w['traffic']}.json").is_file()


def test_metrics_have_readers_and_cells():
    b = _bench()
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert (spec.HERE / "metrics" / f"{m['name']}.py").is_file()
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads",
                                                             cells))
    for c in cells:
        reported = [n for n, m in e2e.items() if c in m.get("workloads",
                                                          [c])]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(c in m["workloads"] for m in b["per_layer"])


def test_limits_and_readings_files_agree():
    for w in _bench()["workloads"]:
        wl = spec.load_json(spec.HERE / "workloads" / f"{w['name']}.json")
        assert wl["limits"] and all(v >= 0 for v in wl["limits"].values())
        json.dumps(wl)
