"""The benchmark of the PyTorch/CUDA port: one cell, one run.

Everything is found by name.  BENCHMARK.json at the root of the checkout
names the cells (workloads), their configuration and traffic mix, and the
metrics; a configuration is benchmark/configs/<config>.json, a traffic mix
benchmark/traffic/<mix>.json, whose "job" names the code that drives one
job of the mix, benchmark/jobs/<job>.py, and each metric has its reader,
benchmark/metrics/<metric>.py.  A later cell, mix, job kind or metric is
added by adding files and entries, never by editing a file here.

A run: set-up (inputs from the seed, kernels built or loaded, the cell's
shapes warmed), then the window, a closed loop of jobs for `seconds`
(jobs start while the window is open and the last one runs to its end),
then the peak memory, then the reference check of what the window
produced, then the metrics.  With trace, a steady part of the window is
profiled (the mix's trace_jobs) and the per-layer metrics are read from it
instead of the end-to-end ones."""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

import tracing
from reference.check import LIMITS, Counts
from reference.curve import Curve

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "halo2_liam_eagen_msm_tpu")


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot, compared
    whole) is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Bench:
    """The benchmark's registry under `root`: BENCHMARK.json and the files
    under benchmark/."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.dir = self.root / "benchmark"
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def _json(self, kind: str, name: str) -> dict:
        return json.loads((self.dir / kind / f"{name}.json").read_text())

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def job_module(self, kind: str):
        return load_module(self.dir / "jobs" / f"{kind}.py", f"bench_job_{kind}")

    def reader(self, metric: str):
        """metrics/<metric>.py; for a metric split by cells, <name>.<cells>
        (as job_s.stream), metrics/<name>.py where it has no reader of its
        own."""
        path = self.dir / "metrics" / f"{metric}.py"
        if not path.is_file():
            path = self.dir / "metrics" / f"{metric.split('.')[0]}.py"
        return load_module(path, f"bench_metric_{metric}")

    def metrics_for(self, workload: str, trace: bool) -> list:
        group = self.spec["per_layer" if trace else "end_to_end"]
        return [m for m in group if workload in m.get("workloads", [workload])]


class Context:
    """What a job's code gets: its configuration, mix, seed, device, the
    reference curve, the run's tracer and its log."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device, tracer: tracing.Tracer, log):
        self.cfg, self.mix, self.seed, self.log = cfg, mix, seed, log
        self.device = torch.device(device)
        self.curve = Curve.from_config(cfg)
        self.tracer = tracer

    def sync(self) -> None:
        self.tracer.sync()


def run_cell(bench: Bench, workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: float | None = None, control=None, log=None):
    """One run of one cell.  Returns (result dict: the last line's keys but
    device, the Counts of the check).  control: a function that rewrites the
    job's kept outputs as a control would have produced them, checked once
    more after the program's own (result["control_checks"]); None in every
    benchmark run."""
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    w = bench.workload(workload)
    cfg, mix = bench.config(w["config"]), bench.traffic(w["traffic"])
    from halo2_liam_eagen_msm_tpu_torch.ops import cuda_ff

    curve = Curve.from_config(cfg)
    tracer = tracing.Tracer(device, trace, curve.p)
    ctx = Context(cfg, mix, seed, device, tracer, log)
    try:
        job = bench.job_module(mix["job"]).Job(ctx)
        t_inputs = time.perf_counter()
        if trace:
            tracer.record_launches(cuda_ff)
        job.warm()
        ctx.sync()
        log(f"set-up: {t_inputs - t_start:.3f} s to the inputs on the device, "
            f"{time.perf_counter() - t_inputs:.3f} s warming")
        if ctx.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(ctx.device)
        rec = {"setup_s": time.perf_counter() - t_start, "jobs": [], "rounds": [],
               "launches": []}
        # the jobs profiled: the mix's trace_jobs; where one traced no device
        # event (the profiler has returned such traces on the card), the job
        # after it, up to two more
        to_profile = set(mix.get("trace_jobs", [])) if trace else set()
        extra = 0
        t0 = time.perf_counter()
        i = 0
        while time.perf_counter() - t0 < seconds or (to_profile and i <= max(to_profile)):
            tracer.job = i
            n0 = sum(cuda_ff.LAUNCHES.values())
            start = time.perf_counter() - t0
            if i in to_profile:
                with tracer.profiled(i), torch.profiler.record_function("job"):
                    job.run(i, rec)
                if ctx.device.type == "cuda" and i not in tracer.profiled_jobs and extra < 2:
                    extra += 1
                    to_profile.add(i + 1)
            else:
                job.run(i, rec)
                ctx.sync()
            rec["jobs"].append((start, time.perf_counter() - t0))
            rec["launches"].append(sum(cuda_ff.LAUNCHES.values()) - n0)
            i += 1
        memory_peak = (torch.cuda.max_memory_allocated(ctx.device)
                       if ctx.device.type == "cuda" else 0)
        log(f"window: {i} jobs in {rec['jobs'][-1][1]:.3f} s, set-up {rec['setup_s']:.3f} s, "
            f"peak {memory_peak} bytes; seconds a job: "
            + " ".join(f"{e - s:.4f}" for s, e in rec["jobs"]))
        if rec["rounds"]:
            r, per = sorted(rec["rounds"]), max(len(rec["rounds"]) // len(rec["jobs"]), 1)
            log(f"window: {len(r)} rounds, ms min {1e3 * r[0]:.2f}, median "
                f"{1e3 * r[len(r) // 2]:.2f}, max {1e3 * r[-1]:.2f}; seconds of rounds a job: "
                + " ".join(f"{sum(rec['rounds'][i:i + per]):.4f}"
                           for i in range(0, len(rec["rounds"]), per)))
    finally:
        tracer.restore()
    if trace:
        rec["trace"] = {"device": tracer.device_events, "spans": tracer.spans,
                        "window_ns": tracer.window_ns, "window_s": tracer.window_s,
                        "profiled_jobs": tracer.profiled_jobs,
                        "under_profiler": tracer.under_profiler, "host": tracer.host,
                        "launches": tracer.launches, "kernels": cuda_ff.KERNELS}
    job.release()
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    counts, failed = job.check(len(rec["jobs"]))
    log(f"check: {time.perf_counter() - t_check:.3f} s")
    control_counts = None
    if control is not None:
        control(job)
        control_counts, _ = job.check(len(rec["jobs"]))
    metrics = {}
    for m in bench.metrics_for(workload, trace):
        value = bench.reader(m["name"]).read(rec, log)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": counts.correct, "attempted": len(rec["jobs"]), "failed": failed,
              "metrics": metrics, "memory_peak_bytes": memory_peak,
              "control_checks": control_counts}
    if trace:
        t = rec["trace"]
        busy = tracing.union_ns([(s, e) for s, e, _ in t["device"]]) / 1e9
        result["busy_s"], result["window_s"] = busy, t["window_s"]
        result["breakdown"] = breakdown(t)
    return result, counts


def breakdown(t: dict) -> dict:
    """The device operations that took most time in the profiled window, by
    name (the program's kernels by their class), and its longest idle gaps,
    each named by the innermost harness span the host was in."""
    by_op = {}
    for s, e, name in t["device"]:
        cls = tracing.kernel_class(name, t["kernels"])
        key = cls if cls in t["kernels"] else f"{cls}: {name.split('<')[0][-48:]}"
        by_op[key] = by_op.get(key, 0.0) + (e - s) / 1e9
    gaps = []
    for ws, we in t["window_ns"]:
        busy = tracing.merged([(max(s, ws), min(e, we)) for s, e, _ in t["device"]
                               if e > ws and s < we])
        edges = [ws] + [x for iv in busy for x in iv] + [we]
        for g0, g1 in zip(edges[0::2], edges[1::2]):
            if g1 > g0:
                gaps.append((g0, g1))
    named = []
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        inner = [(s, e, n) for n, ivs in t["spans"].items() for s, e in ivs if s <= g0 < e]
        name = min(inner, key=lambda iv: iv[1] - iv[0])[2] if inner else "between jobs"
        named.append([name, (g1 - g0) / 1e9])
    return {"device_ops": sorted(([k, v] for k, v in by_op.items()),
                                 key=lambda kv: -kv[1])[:10],
            "idle_gaps": named}


def check_lines(counts: Counts) -> list:
    return [f"check {k}: {counts[k]} (limit {LIMITS[k]})" for k in LIMITS]
