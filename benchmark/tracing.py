"""Spans, launch records and the profiler window of a traced run, and the
arithmetic the per-layer readers share.

The spans are put around calls into the program's layers from here, by
wrapping module attributes of the program for the length of a run (the
program is not edited).  In a traced run a span synchronises the card at
both ends, so the device work that a span's calls enqueue starts after the
span opens and ends before it closes: a device event belongs to the span
whose host interval holds its start.  Spans are torch.profiler
record_function ranges, so their intervals share the trace's clock."""

from __future__ import annotations

import contextlib
import time

import torch

import bounds

# device events of these classes are the copies, pads and fills of a layer
COPY_CLASSES = ("memcpy", "memset", "copy", "fill", "cat")


def kernel_class(name: str, kernels) -> str:
    """A device event's class: the program's kernel by name (its CUDA
    function is <kernel>_kernel), else what PyTorch's kernel does (copy,
    reduce, fill, cat, other elementwise), memcpy or memset."""
    for k in sorted(kernels, key=len, reverse=True):
        if k + "_kernel" in name:
            return k
    low = name.lower()
    for key, cls in (("memcpy", "memcpy"), ("memset", "memset"), ("copy", "copy"),
                     ("reduce", "reduce"), ("fill", "fill"), ("catarray", "cat")):
        if key in low:
            return cls
    return "other elementwise"


def merged(intervals):
    """Sorted, merged (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def union_ns(intervals) -> int:
    return sum(e - s for s, e in merged(intervals))


def in_spans(events, spans):
    """The device events (start, end, name) whose start lies in one of the
    host intervals `spans`."""
    spans = sorted(spans)
    out, i = [], 0
    for ev in sorted(events):
        while i < len(spans) and spans[i][1] < ev[0]:
            i += 1
        if i < len(spans) and spans[i][0] <= ev[0]:
            out.append(ev)
    return out


class Tracer:
    """The spans and launch records of one run.  `enabled` only in a traced
    run: otherwise a wrapped call runs as it is and only its capture (the
    outputs kept for the check) is taken."""

    def __init__(self, device, enabled: bool, p: int):
        self.device = torch.device(device)
        self.enabled = enabled
        self.p = p
        self.job = -1                 # the job the harness is running
        self.host = {}                # span -> [(job, seconds)] (host clock, synchronised)
        self.launches = []            # (kernel, bound ms or None) while a window is profiled
        self.device_events = []       # (start ns, end ns, name)
        self.spans = {}               # span -> [(start ns, end ns)] host intervals
        self.window_ns = []           # profiled windows (start ns, end ns)
        self.window_s = 0.0
        self.profiled_jobs = []       # jobs whose trace is read
        self.under_profiler = []      # every job run under the profiler
        self._recording = False
        self._undo = []

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def wrap(self, module, attr: str, span: str | None = None, capture=None) -> None:
        """Replace module.attr by a wrapper that keeps the outputs
        (capture(out)) and, in a traced run, times the call as `span`."""
        real = getattr(module, attr)
        tracer = self

        def wrapped(*args, **kwargs):
            if span is None or not tracer.enabled:
                out = real(*args, **kwargs)
            else:
                tracer.sync()
                t0 = time.perf_counter()
                with torch.profiler.record_function(span):
                    out = real(*args, **kwargs)
                    tracer.sync()
                tracer.host.setdefault(span, []).append((tracer.job, time.perf_counter() - t0))
            if capture is not None:
                capture(out)
            return out

        setattr(module, attr, wrapped)
        self._undo.append((module, attr, real))

    def record_launches(self, cuda_ff) -> None:
        """Record each kernel launch's bound while a window is profiled."""
        tracer = self

        def launch(name, dev, *args):
            real(name, dev, *args)
            if tracer._recording:
                tracer.launches.append((name, bounds.launch_bound_ms(name, args, tracer.p)))

        real = cuda_ff._launch
        cuda_ff._launch = launch
        self._undo.append((cuda_ff, "_launch", real))

    def restore(self) -> None:
        for module, attr, real in reversed(self._undo):
            setattr(module, attr, real)
        self._undo = []

    @contextlib.contextmanager
    def profiled(self, job: int):
        """Profile the device and the host over the block (one job).  On a
        card, a job whose trace holds no device event (the profiler has
        returned such traces there) is left out whole: its launches, spans
        and window are dropped and it is not among profiled_jobs."""
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.sync()
        n_launches = len(self.launches)
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            self._recording = True
            with record_function("window"):
                yield
                self.sync()
            self._recording = False
            t1 = time.perf_counter()
        self._add(job, self._read(prof), t1 - t0, n_launches)

    def _add(self, job: int, read, seconds: float, n_launches: int) -> None:
        """Keep a profiled job's (device events, spans, windows), or on a
        card drop the job where it traced no device event."""
        device, spans, window = read
        self.under_profiler.append(job)
        if self.device.type == "cuda" and not device:
            del self.launches[n_launches:]
            return
        self.device_events += device
        for name, ivs in spans.items():
            self.spans.setdefault(name, []).extend(ivs)
        self.window_ns += window
        self.window_s += seconds
        self.profiled_jobs.append(job)

    @staticmethod
    def _read(prof):
        """(device events, host spans, windows) from the profiler's raw
        events."""
        device, spans, window = [], {}, []
        for ev in prof.profiler.kineto_results.events():
            start = ev.start_ns()
            end = start + ev.duration_ns()
            on_device = "CUDA" in str(ev.device_type())
            if ev.is_user_annotation():
                if not on_device:
                    if ev.name() == "window":
                        window.append((start, end))
                    else:
                        spans.setdefault(ev.name(), []).append((start, end))
            elif on_device:
                device.append((start, end, ev.name()))
        return device, spans, window
