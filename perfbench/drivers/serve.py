"""Serving: ``ServeEngine.tick`` in a closed loop of clients.

Set-up makes the weights from the seed in the dtype they are served in,
builds the engine (its stop predicate captured and built), and warms up
one prefill at the longest prompt and the ticks that finish it. Each
client then sends its next request when its last one finishes; the
window opens once the clients' first requests have all been served, and
every tick of it is one ``tick()``. After the window the engine is
closed and freed, and the reference runs over a sample of the finished
requests, drawn from the seed with the longest of them in it: its float32
logits at every served position, against which each served token's
logit may lie below the best by at most the limit. Every finished
request's length is also held to the plain stop rule."""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from perfbench import checks, flops, spec, traffic, weights
from perfbench.reference import dense as ref


def stop_length(req, eos: int, max_len: int) -> int:
    """How many tokens the plain rule serves: after each decoded token,
    stop on ``eos``, at ``max_new_tokens`` tokens, or at the context cap
    (``pos >= max_len - 1``); the prefill's token is never tested. -1
    when the rule does not stop within the tokens served."""
    pos = len(req.prompt)
    for n in range(2, len(req.out_tokens) + 1):
        pos += 1
        if (req.out_tokens[n - 1] == eos or n >= req.max_new_tokens
                or pos >= max_len - 1):
            return n
    return -1


def sample(done: list, seed: int, budget: int) -> list:
    """Finished requests to check: the one with most served tokens, the
    one with the longest prompt, then others in an order drawn from the
    seed, weighted by their share of served tokens among the reference's
    (so its time buys more of them), while the reference's tokens stay
    within ``budget``."""
    if not done:
        return []
    most = max(done, key=lambda r: (len(r.out_tokens), len(r.prompt)))
    longest = max(done, key=lambda r: len(r.prompt))
    picked = [most] + ([longest] if longest is not most else [])
    used = sum(len(r.prompt) + len(r.out_tokens) for r in picked)
    w = np.asarray([len(r.out_tokens) / (len(r.prompt) + len(r.out_tokens))
                    for r in done], np.float64)
    order = traffic.rng(seed, 3).choice(len(done), size=len(done),
                                        replace=False, p=w / w.sum())
    for i in order:
        r = done[int(i)]
        size = len(r.prompt) + len(r.out_tokens)
        if r in picked or used + size > budget:
            continue
        picked.append(r)
        used += size
    return picked


def served_positions(req, device):
    ids = np.concatenate([req.prompt, np.asarray(req.out_tokens[:-1],
                                                 np.int32)])
    t = len(req.prompt)
    pos = torch.arange(t - 1, t - 1 + len(req.out_tokens), device=device)
    return torch.as_tensor(ids.astype(np.int64), device=device), pos


def ref_logits(a, params, reqs, device, precision="fp32"):
    """The reference's float32 logits at every served position of each
    request (its prompt and served tokens run once, whole)."""
    seqs, poss = zip(*(served_positions(r, device) for r in reqs))
    return ref.logits_at(a, params, list(seqs), list(poss), precision)


def gaps_of(logits, tokens) -> float:
    """The widest gap by which a token's logit lies below the best."""
    worst = 0.0
    for lg, tok in zip(logits, tokens):
        t = torch.as_tensor(np.asarray(tok, np.int64), device=lg.device)
        g = lg.max(dim=1).values - lg.gather(1, t[:, None])[:, 0]
        worst = max(worst, float(g.max()))
    return worst


def program(cell: dict, seed: int, device, trace: bool):
    from repro_torch.serve.engine import ServeEngine
    conf, wl = cell["config"], cell["workload"]
    eng = wl["engine"]
    cfg = spec.port_config(conf, cell["entry"]["config"], dtype=eng["dtype"])
    params = weights.make(conf, weights.shapes(cfg), seed, device,
                          getattr(torch, eng["dtype"]))
    engine = ServeEngine(cfg, params=params, max_batch=eng["max_batch"],
                         max_len=eng["max_len"], eos_id=wl["eos_id"],
                         pum_bulk=eng["pum_bulk"], telemetry=trace,
                         async_stop=eng["async_stop"], device=device)
    return params, engine


def warm_up(engine, wl: dict, vocab: int, seed: int) -> None:
    from repro_torch.serve.engine import Request
    g = traffic.rng(seed, 4)
    prompt = g.integers(0, vocab, wl["warmup_prompt_tokens"]).astype(np.int32)
    engine.submit(Request(rid=-1, prompt=prompt, max_new_tokens=2))
    engine.run_until_drained(max_ticks=8)
    engine.finished.clear()


def run(cell: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float, fault=None, keep: bool = False) -> dict:
    from repro_torch.serve.engine import Request
    from perfbench.trace import Stretch
    conf, wl, traf = cell["config"], cell["workload"], cell["traffic"]
    a = spec.arch(conf)
    vocab = conf["vocab_size"]
    params, engine = program(cell, seed, device, trace)
    if fault is not None:
        fault(engine)
    warm_up(engine, wl, vocab, seed)
    stream = traffic.serve_requests(traf, vocab, seed)
    sent: list = []

    def send():
        spec_ = stream[len(sent) % len(stream)]
        r = Request(rid=len(sent), prompt=spec_["prompt"],
                    max_new_tokens=spec_["max_new_tokens"])
        sent.append(r)
        engine.submit(r)

    n_done = 0
    client_spans: list = []

    def tick():
        nonlocal n_done
        engine.tick()
        t0 = time.perf_counter_ns()
        for _ in engine.finished[n_done:]:
            send()                      # that client's next request
        n_done = len(engine.finished)
        client_spans.append(("client.send", t0, time.perf_counter_ns()))

    # The clients start together; the window opens once each has had a
    # request served, so the start's burst of admissions stays in set-up.
    for _ in range(traf["clients"]):
        send()
    while len(engine.finished) < traf["clients"]:
        tick()
    w0 = time.perf_counter()
    setup_s = w0 - t_start
    ticks = 0
    while time.perf_counter() - w0 < seconds:
        tick()
        ticks += 1
    w1 = time.perf_counter()
    in_window = [r for r in sent if r.t_first and w0 <= r.t_first <= w1]
    record = {"setup_s": setup_s, "window_s": w1 - w0, "ticks": ticks,
              "attempted": len(in_window),
              "failed": sum(any(t < 0 or t >= vocab for t in r.out_tokens)
                            for r in in_window)}
    record["ttft_s"] = [r.t_first - r.t_submit for r in in_window]
    record["tokens"] = sum(len(r.prompt) + len(r.out_tokens)
                           for r in in_window)
    record["flops"] = sum(
        flops.prefill(a, len(r.prompt))
        + sum(flops.decode_token(a, len(r.prompt) + i)
              for i in range(1, len(r.out_tokens)))
        for r in in_window)
    record["spans"] = ([(n, t0, t1) for n, t0, t1, _ in engine.tracer.events
                        if w0 * 1e9 <= t0 <= w1 * 1e9]
                       if engine.tracer is not None else [])
    record["trace"] = None
    if trace:
        n_spans = len(engine.tracer.events)
        c0 = len(client_spans)
        with Stretch() as st:
            for _ in range(wl["trace_ticks"]):
                tick()
        host = [(n, t0, t1) for n, t0, t1, _ in
                engine.tracer.events[n_spans:]] + client_spans[c0:]
        record["trace"] = st.read(host)
    if torch.cuda.is_available() and torch.device(device).type == "cuda":
        record["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
    done = [r for r in engine.finished if r.done]
    engine.close()
    engine.caches = engine.params = None    # the closures keep the engine
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    stop_bad = sum(stop_length(r, wl["eos_id"], wl["engine"]["max_len"])
                   != len(r.out_tokens) for r in done)
    picked = sample(done, seed, wl["check"]["reference_tokens"])
    ref.strict_fp32()
    t0 = time.perf_counter()
    logits = ref_logits(a, params, picked, device)
    values = {"logit_gap": gaps_of(logits, [r.out_tokens for r in picked]),
              "stop_mismatches": stop_bad}
    record["checks"] = checks.judge(values, wl["limits"])
    record["notes"] = {"checked_requests": len(picked),
                       "checked_tokens": sum(len(r.out_tokens) for r in picked),
                       "finished_requests": len(done),
                       "ttft_samples": len(record["ttft_s"]),
                       "setup_s": setup_s, "window_s": w1 - w0,
                       "reference_s": time.perf_counter() - t0}
    if keep:
        record["kept"] = {"logits": logits, "picked": picked,
                          "params": params}
    return record
