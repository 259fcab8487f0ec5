"""Mean `serve.decode` span (one decode step over all slots, to the tokens on the host)."""


def read(rec):
    if rec["kind"] != "serve":
        return None
    spans = [t1 - t0 for n, t0, t1 in rec.get("spans", ())
             if n == "serve.decode"]
    den = len(spans)
    if not den:
        return None
    return sum(spans) / den / 1e6
