"""Prompt tokens prefilled plus tokens served, of the requests whose
first token came in the window, over the window."""


def read(rec):
    if rec["kind"] != "serve" or not rec["attempted"]:
        return None
    return rec["tokens"] / rec["window_s"]
