"""Set-up: process start to the window's start (imports, weights,
program state, warm-up; the nvcc builds in a checkout's first run)."""


def read(rec):
    return rec["setup_s"]
