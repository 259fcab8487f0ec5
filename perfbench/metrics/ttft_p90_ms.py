"""90th percentile of time to first token (submit to first token on
the host) over every request whose first token came in the window."""

import statistics


def read(rec):
    if rec["kind"] != "serve" or len(rec["ttft_s"]) < 2:
        return None
    q = statistics.quantiles(rec["ttft_s"], n=10, method="inclusive")
    return q[8] * 1e3
