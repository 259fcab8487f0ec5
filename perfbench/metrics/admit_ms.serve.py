"""Mean `serve.admit` span (prefill and cache write) per request admitted in the window."""


def read(rec):
    if rec["kind"] != "serve":
        return None
    spans = [t1 - t0 for n, t0, t1 in rec.get("spans", ())
             if n == "serve.admit"]
    den = max(rec["attempted"], 1) if spans else 0
    if not den:
        return None
    return sum(spans) / den / 1e6
