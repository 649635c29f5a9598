"""tree_copy_ms: the device time of the copies, pads and fills inside the
merge tree's spans (PyTorch's copy, fill and cat kernels, memcpy and
memset: the layout work around the ntt and poly kernels and the fused lm
tail), a job, over the profiled jobs."""

import tracing


def read(rec, log):
    t = rec.get("trace")
    if not t or not t["device"] or not t["spans"].get("tree"):
        return None
    evs = tracing.in_spans(t["device"], t["spans"]["tree"])
    ns = sum(e - s for s, e, name in evs
             if tracing.kernel_class(name, t["kernels"]) in tracing.COPY_CLASSES)
    return ns / 1e6 / len(t["profiled_jobs"])
