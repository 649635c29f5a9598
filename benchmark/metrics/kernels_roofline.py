"""kernels_roofline: over the profiled jobs' launches of the kernels the
bounds cover (bounds.COVERED), the sum of each launch's least time at its
own shape over their summed device time, in percent.  It logs which kernels
were covered and their share of the device time first."""

import bounds
import tracing


def read(rec, log):
    t = rec.get("trace")
    if not t or not t["device"]:
        return None
    bound_ms = sum(b for name, b in t["launches"] if b is not None)
    dev_ns, total_ns = {}, 0
    for s, e, name in t["device"]:
        total_ns += e - s
        cls = tracing.kernel_class(name, t["kernels"])
        if cls in bounds.COVERED:
            dev_ns[cls] = dev_ns.get(cls, 0) + e - s
    covered_ms = sum(dev_ns.values()) / 1e6
    if covered_ms <= 0 or bound_ms <= 0:
        return None
    log("kernels_roofline covers " + ", ".join(
        f"{k} {v / 1e6:.3f} ms" for k, v in sorted(dev_ns.items(), key=lambda kv: -kv[1]))
        + f": {100 * sum(dev_ns.values()) / total_ns:.2f} % of the device time; "
        f"bound {bound_ms:.3f} ms over {covered_ms:.3f} ms")
    return 100 * bound_ms / covered_ms
