"""device_idle_pct: the share of the profiled window in which the device
runs nothing (no kernel, copy or fill), in percent.  It is read on a host
that the profiler and the spans' synchronisations slow (a traced job takes
longer than an untraced one, with the same device work), so it lies above
the idle share of an untraced job: compare it only between traced runs."""

import tracing


def read(rec, log):
    t = rec.get("trace")
    if not t or not t["device"] or not t["window_ns"]:
        return None
    window = sum(e - s for s, e in t["window_ns"])
    busy = sum(tracing.union_ns([(max(s, ws), min(e, we)) for s, e, _ in t["device"]
                                 if e > ws and s < we]) for ws, we in t["window_ns"])
    return 100 * (1 - busy / window)
