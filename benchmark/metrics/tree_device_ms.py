"""tree_device_ms: the device's busy time (the union of its kernels,
copies and fills) inside the merge tree's spans (divisor's
compute_divisor_witness_partial), a job, over the profiled jobs."""

import tracing


def read(rec, log):
    t = rec.get("trace")
    if not t or not t["device"] or not t["spans"].get("tree"):
        return None
    evs = tracing.in_spans(t["device"], t["spans"]["tree"])
    return tracing.union_ns([(s, e) for s, e, _ in evs]) / 1e6 / len(t["profiled_jobs"])
