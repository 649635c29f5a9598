"""kernel_launches: the program's kernel launches a job (the sum of
ops/cuda_ff.LAUNCHES over the job), mean over the traced run's jobs."""


def read(rec, log):
    if not rec.get("trace") or not rec["launches"]:
        return None
    return sum(rec["launches"]) / len(rec["launches"])
