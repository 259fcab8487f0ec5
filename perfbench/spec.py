"""Loading a cell by name: ``BENCHMARK.json``, the configuration, the
cell's own file and its traffic mix, and the port's ``ModelConfig`` for a
configuration file."""

from __future__ import annotations

import json
import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[1]
HERE = pathlib.Path(__file__).resolve().parent


def load_json(path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def benchmark(root: pathlib.Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(name: str, bench: dict | None = None) -> dict:
    """The cell ``name``: its ``BENCHMARK.json`` entry with the loaded
    ``config`` file, the cell's own file (``workload``) and its
    ``traffic`` file."""
    bench = bench or benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return {"entry": entry,
            "config": load_json(ROOT / conf["file"]),
            "workload": load_json(HERE / "workloads" / f"{name}.json"),
            "traffic": load_json(HERE / "traffic" / f"{entry['traffic']}.json")}


def published(config: dict, key: str):
    """A key of the published configuration, or of its ``assumed``
    values where the source could not be confirmed."""
    if key in config:
        return config[key]
    return config["assumed"][key]


def arch(config: dict) -> dict:
    """The sizes and switches of a dense decoder, from the published
    keys (plain values: the reference and the FLOP count read these)."""
    d = config["hidden_size"]
    h = config["num_attention_heads"]
    return {
        "layers": config["num_hidden_layers"],
        "d": d,
        "heads": h,
        "kv_heads": config["num_key_value_heads"],
        "head_dim": config.get("head_dim") or d // h,
        "d_ff": config["intermediate_size"],
        "vocab": config["vocab_size"],
        "tied": bool(config["tie_word_embeddings"]),
        "rope_theta": float(config["rope_theta"]),
        "eps": float(published(config, "rms_norm_eps")),
        "qkv_bias": bool(config["architecture"]["qkv_bias"]),
        "qk_norm": bool(config["architecture"]["qk_norm"]),
    }


def port_config(config: dict, name: str, dtype: str = "bfloat16",
                remat: str = "full"):
    """The port's ``ModelConfig`` for a configuration file, as published.
    The port's RMSNorm has no eps setting (it uses 1e-6)."""
    from repro_torch.config.base import ModelConfig
    a = arch(config)
    return ModelConfig(
        name=name, family="dense", n_layers=a["layers"], d_model=a["d"],
        n_heads=a["heads"], n_kv_heads=a["kv_heads"],
        head_dim=a["head_dim"], d_ff=a["d_ff"], vocab_size=a["vocab"],
        qkv_bias=a["qkv_bias"], qk_norm=a["qk_norm"],
        rope_theta=a["rope_theta"], tie_embeddings=a["tied"], dtype=dtype,
        remat=remat)
