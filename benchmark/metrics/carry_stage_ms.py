"""carry_stage_ms: the host clock around the carry stage (the call into
argument: _carries_only, or _rounds_and_carries in the batched job),
synchronised at both ends, mean a job over the traced run's jobs that were
not run under the profiler (it slows the host)."""


def read(rec, log):
    t = rec.get("trace")
    if not t:
        return None
    times = [s for job, s in t["host"].get("carry_stage", []) if job >= 0]
    plain = [s for job, s in t["host"].get("carry_stage", [])
             if job >= 0 and job not in t["under_profiler"]]
    times = plain or times
    return sum(times) / len(times) * 1e3 if times else None
