"""round_p95_ms: the 95th percentile of the times of all digit rounds in
the window, each round from the end of the one before (or of the carry
stage) to its own synchronise: the tail a consumer that commits each round
as it arrives waits for."""

import statistics


def read(rec, log):
    rounds = rec["rounds"]
    if len(rounds) < 2:
        return None
    return statistics.quantiles(rounds, n=20, method="inclusive")[18] * 1e3
