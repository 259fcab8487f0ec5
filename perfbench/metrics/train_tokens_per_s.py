"""Tokens of all training steps completed in the window over the time
they took (each step from its host batch to its loss read-back)."""


def read(rec):
    if rec["kind"] != "train" or not rec["steps"]:
        return None
    return rec["tokens"] / rec["window_s"]
