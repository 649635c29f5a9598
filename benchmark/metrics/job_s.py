"""job_s: the seconds from the window's start to the end of its last
completed job, over the jobs completed (host clock, every job ending in a
synchronise)."""


def read(rec, log):
    jobs = rec["jobs"]
    return jobs[-1][1] / len(jobs) if jobs else None
