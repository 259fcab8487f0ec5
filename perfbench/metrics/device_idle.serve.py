"""Share of the traced stretch in which no kernel, copy or set ran on
the card (``torch.profiler``), in percent."""


def read(rec):
    tr = rec.get("trace")
    if rec["kind"] != "serve" or not tr or not tr["busy_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
