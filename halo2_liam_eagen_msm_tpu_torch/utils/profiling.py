"""Profiling and timing harness: torch.profiler traces and a wall-clock
benchmark that emits the BASELINE metric line, the counterpart of the JAX
package's utils/profiling.py."""

from __future__ import annotations

import contextlib
import json
import os
import time

import torch


@contextlib.contextmanager
def trace(dirname: str):
    """Trace a block with torch.profiler (host and card) and write a Chrome
    trace (trace.json, for Perfetto or chrome://tracing) into dirname."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(dirname, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(dirname, "trace.json"))


def benchmark(fn, *args, reps: int = 3, warmup: int = 1, sync=None):
    """Best-of wall-clock timing after `warmup` calls; returns (best, all).

    sync: called after each call so that the clock waits for the device
    (defaults to torch.cuda.synchronize; pass a no-op for work on the
    CPU)."""
    sync = sync or torch.cuda.synchronize
    for _ in range(warmup):
        fn(*args)
        sync()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args)
        sync()
        times.append(time.perf_counter() - t0)
    return min(times), times


def metric_line(metric: str, value: float, unit: str, baseline: float) -> str:
    """The one-line JSON metric format of the repository's benchmarks (bench.py)."""
    return json.dumps(
        {
            "metric": metric,
            "value": round(value, 1),
            "unit": unit,
            "vs_baseline": round(value / baseline, 4),
        }
    )
