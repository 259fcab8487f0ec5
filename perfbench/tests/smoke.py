"""Cells of the benchmark cut to a size the CPU tests can run: the same
files, with the widths, depth, vocabulary and traffic shrunk."""

from __future__ import annotations

import copy

from perfbench import spec

SMALL = {"hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 2,
         "head_dim": 16, "intermediate_size": 96, "num_hidden_layers": 2,
         "vocab_size": 300}


def small_cell(name: str) -> dict:
    cell = copy.deepcopy(spec.cell(name))
    conf = cell["config"]
    conf.update(SMALL)
    std = conf["weights"]["normal_std"]
    for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up"):
        std[k] = SMALL["hidden_size"] ** -0.5
    std["w_down"] = SMALL["intermediate_size"] ** -0.5
    traf, wl = cell["traffic"], cell["workload"]
    if wl["driver"] == "train":
        traf.update(seq_len=32, seqs_per_step=4)
    else:
        traf.update(block=4, blocks=4, clients=2)
        traf["prompt_tokens"].update(lo=8, hi=20)
        traf["output_tokens"].update(lo=3, hi=6)
        wl["engine"].update(max_batch=2, max_len=32, dtype="float32")
        wl.update(eos_id=299, warmup_prompt_tokens=20, trace_ticks=2)
        wl["check"]["reference_tokens"] = 200
    return cell
