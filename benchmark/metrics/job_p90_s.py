"""job_p90_s: the 90th percentile of the latencies of all jobs in the window
(host clock, each job ending in a synchronise; a closed loop, so a job's
latency is its own duration)."""

import statistics


def read(rec, log):
    lat = [end - start for start, end in rec["jobs"]]
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=10, method="inclusive")[8]
