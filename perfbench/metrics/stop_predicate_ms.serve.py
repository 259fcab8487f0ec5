"""Mean `serve.stop_predicate` span (the captured PuM stop program: K1 and K2 on the card)."""


def read(rec):
    if rec["kind"] != "serve":
        return None
    spans = [t1 - t0 for n, t0, t1 in rec.get("spans", ())
             if n == "serve.stop_predicate"]
    den = len(spans)
    if not den:
        return None
    return sum(spans) / den / 1e6
