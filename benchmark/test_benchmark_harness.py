"""The harness on the CPU at 64 points: both cells correct against the
reference, the control and each fault the cells can have read as not
correct, discovery by name, and the refusals of run.py.

    python -m pytest benchmark/test_benchmark_harness.py -q

(about ten minutes on one CPU: a streamed job is 56 rounds of the merge
tree on the plain PyTorch versions)."""

import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import control
import harness
from reference.curve import Curve

HERE = Path(__file__).resolve().parent
STREAM, BATCHED = "witness_2e20_stream", "witness_2e16_batched"
SEED = 2**31 + 2**20 + 7


def tiny_copy(dest: Path) -> Path:
    """The benchmark under dest at 64 points, every job's outputs checked."""
    shutil.copytree(HERE, dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "test_*.py", "conftest.py"))
    spec = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        f = dest / c["file"]
        cfg = json.loads(f.read_text())
        cfg["num_points"] = 64
        f.write_text(json.dumps(cfg))
    for name, upd in (("stream_pool2", {"witness_jobs": 1, "witness_rounds": 4}),
                      ("batched_pool4", {"witness_jobs": 1, "jobs_checked": 1,
                                         "trace_jobs": [1]})):
        f = dest / "benchmark" / "traffic" / f"{name}.json"
        f.write_text(json.dumps({**json.loads(f.read_text()), **upd}))
    (dest / "BENCHMARK.json").write_text(json.dumps(spec))
    return dest


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return harness.Bench(tiny_copy(tmp_path_factory.mktemp("bench")))


def lazy_control(bench):
    return control.lazy(Curve.from_config(bench.config("pallas_2e16")).p)


@pytest.mark.parametrize("workload", [BATCHED, STREAM])
def test_cell_correct_and_control_not(tiny, workload):
    res, counts = harness.run_cell(tiny, workload, SEED, 0.01, False, "cpu",
                                   control=lazy_control(tiny))
    assert res["correct"] and res["failed"] == 0 and all(v == 0 for v in counts.values())
    job, tail = ("job_s", "job_p90_s") if workload == BATCHED else ("job_s.stream", "round_p95_ms")
    # a tail is left out where the window holds too few jobs or rounds
    assert {"setup_s", job} <= set(res["metrics"]) <= {"setup_s", job, tail}
    ctl = res["control_checks"]
    assert not ctl.correct and ctl["limbs_noncanonical"] > 0
    # the witness was read: its rows past the degree are no longer zero
    assert ctl["witness_degree_wrong"] > 0


def unchanged_state(monkeypatch):
    """The carry scan's step returns its state unchanged."""
    from halo2_liam_eagen_msm_tpu_torch import argument as A
    real = A._carry_scan

    def scan(curve, base, sx, sy, sz):
        prev, new, final = real(curve, base, sx, sy, sz)
        return prev, prev, JPointOf(prev, 0)

    def JPointOf(p, k):
        return type(p)(*(c[k] for c in p))
    monkeypatch.setattr(A, "_carry_scan", scan)


def half_batch(monkeypatch):
    """The tree takes half of each round's slots and leaves out the rest."""
    from halo2_liam_eagen_msm_tpu_torch import divisor as D
    from halo2_liam_eagen_msm_tpu_torch.models import eagen_msm as M
    real = D.compute_divisor_witness_partial

    def tree(curve, pts):
        s = pts.x.shape[-2]
        return real(curve, type(pts)(*(c[..., : s // 2, :] for c in pts)))
    monkeypatch.setattr(D, "compute_divisor_witness_partial", tree)
    monkeypatch.setattr(M, "compute_divisor_witness_partial", tree)


def altered_answer(monkeypatch):
    """One coefficient of each witness altered where the tree makes it."""
    from halo2_liam_eagen_msm_tpu_torch import divisor as D
    from halo2_liam_eagen_msm_tpu_torch.models import eagen_msm as M
    real = D.compute_divisor_witness_partial

    def tree(curve, pts):
        wtns, out = real(curve, pts)
        a = wtns.a.clone()
        a[..., 1, 0] ^= 1
        return type(wtns)(a, wtns.b), out
    monkeypatch.setattr(D, "compute_divisor_witness_partial", tree)
    monkeypatch.setattr(M, "compute_divisor_witness_partial", tree)


def moved_zeros(monkeypatch):
    """Two slots of each round moved before the tree, their sum kept: a
    copy of -carry_prev by +G and a digit slot by -G.  The witness closes
    and keeps its pole order; two of its zeros are wrong."""
    import inputs
    from halo2_liam_eagen_msm_tpu_torch import divisor as D
    from halo2_liam_eagen_msm_tpu_torch.models import eagen_msm as M
    from halo2_liam_eagen_msm_tpu_torch.ops.ec import ec
    real = D.compute_divisor_witness_partial

    def tree(curve, pts):
        E = ec(curve)
        g = [torch.from_numpy(inputs.mont_limbs([v], curve.field.p)).to(pts.x.device)
             for v in (curve.gen_x, curve.gen_y, 1)]
        cols = [c.clone() for c in pts]
        for s, sign in ((1, 1), (8, -1)):
            at = type(pts)(*(c[..., s:s + 1, :] for c in pts))
            gen = type(pts)(*(v.expand_as(c) for v, c in zip(g, at)))
            moved = E.add(at, gen if sign > 0 else E.neg(gen))
            for c, m in zip(cols, moved):
                c[..., s:s + 1, :] = m
        return real(curve, type(pts)(*cols))
    monkeypatch.setattr(D, "compute_divisor_witness_partial", tree)
    monkeypatch.setattr(M, "compute_divisor_witness_partial", tree)


def scaled_witness(monkeypatch):
    """Every witness doubled where the tree makes it: its divisor kept, its
    scale not the convention's."""
    from halo2_liam_eagen_msm_tpu_torch import divisor as D
    from halo2_liam_eagen_msm_tpu_torch.models import eagen_msm as M
    from halo2_liam_eagen_msm_tpu_torch.ops.ff import ff
    real = D.compute_divisor_witness_partial

    def tree(curve, pts):
        wtns, out = real(curve, pts)
        k = ff(curve.field)
        return type(wtns)(k.add(wtns.a, wtns.a), k.add(wtns.b, wtns.b)), out
    monkeypatch.setattr(D, "compute_divisor_witness_partial", tree)
    monkeypatch.setattr(M, "compute_divisor_witness_partial", tree)


@pytest.mark.parametrize("workload,fault,count", [
    (BATCHED, unchanged_state, None), (BATCHED, half_batch, None),
    (BATCHED, altered_answer, None), (STREAM, altered_answer, None),
    (BATCHED, moved_zeros, "witness_divisor_wrong"), (STREAM, moved_zeros, "witness_divisor_wrong"),
    (STREAM, scaled_witness, "witness_scale_wrong")])
def test_faults_read_not_correct(tiny, monkeypatch, workload, fault, count):
    """The harness's run with its look for a card skipped and the timed path
    broken underneath: correct comes out false (one chip: no exchange); a
    fault that only one count can see reads there."""
    fault(monkeypatch)
    res, counts = harness.run_cell(tiny, workload, SEED + 1, 0.01, False, "cpu")
    assert not res["correct"] and res["failed"] > 0, dict(counts)
    if count:
        assert counts[count] > 0, dict(counts)


def test_traced_run_reads_what_the_cpu_has(tiny):
    res, counts = harness.run_cell(tiny, BATCHED, SEED + 2, 0.01, True, "cpu")
    assert res["correct"]
    # host spans and counters are read; device metrics need the card's trace
    assert set(res["metrics"]) == {"carry_stage_ms", "kernel_launches"}
    assert res["busy_s"] == 0 and res["window_s"] > 0


def test_a_job_the_profiler_did_not_trace_is_left_out():
    """On a card, a profiled job whose trace holds no device event adds no
    launches, spans or window, and is not among the jobs traced."""
    import tracing
    tr = tracing.Tracer("cpu", True, 7)
    tr.device = torch.device("cuda")
    tr.launches = [("lm_mul", 0.1)]
    tr._add(0, ([(0, 10, "lm_mul_kernel")], {"tree": [(0, 20)]}, [(0, 30)]), 0.5, 0)
    tr.launches.append(("lm_mul", 0.1))
    tr._add(1, ([], {"tree": [(40, 50)]}, [(40, 60)]), 0.7, 1)
    assert tr.profiled_jobs == [0] and tr.under_profiler == [0, 1]
    assert tr.launches == [("lm_mul", 0.1)] and tr.spans == {"tree": [(0, 20)]}
    assert tr.window_ns == [(0, 30)] and tr.window_s == 0.5


def digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_discovery_by_name(tmp_path):
    """A throwaway configuration, mix and metric, added as files and entries
    only, are found by name; no file that was there changes."""
    root = tiny_copy(tmp_path)
    before = digest(root / "benchmark")
    b = root / "benchmark"
    cfg = json.loads((b / "configs" / "pallas_2e16.json").read_text())
    (b / "configs" / "throwaway_cfg.json").write_text(json.dumps({**cfg, "num_points": 32}))
    mix = json.loads((b / "traffic" / "batched_pool4.json").read_text())
    (b / "traffic" / "throwaway_mix.json").write_text(json.dumps({**mix, "pool": 1}))
    (b / "metrics" / "throwaway_metric.py").write_text(
        "def read(rec, log):\n    return 1000.0 * len(rec['jobs'])\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({**spec["configs"][1], "name": "throwaway_cfg",
                            "file": "benchmark/configs/throwaway_cfg.json"})
    spec["workloads"].append({"name": "throwaway_cell", "config": "throwaway_cfg",
                              "traffic": "throwaway_mix", "chips": 1, "why": "a test"})
    for m in spec["end_to_end"]:
        if m["name"] == "job_s":
            m["workloads"].append("throwaway_cell")
    spec["end_to_end"].append({"name": "throwaway_metric", "unit": "jobs", "better": "higher",
                               "bound": 0.01, "source": "host_clock",
                               "workloads": ["throwaway_cell"]})
    # a metric split by cells is read by its name's reader
    spec["end_to_end"].append({"name": "throwaway_metric.split", "unit": "jobs",
                               "better": "higher", "bound": 0.01, "source": "host_clock",
                               "workloads": ["throwaway_cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    res, _ = harness.run_cell(harness.Bench(root), "throwaway_cell", SEED, 0.01, False, "cpu")
    assert res["correct"]
    assert res["metrics"]["throwaway_metric"]["value"] == 1000.0 * res["attempted"]
    assert res["metrics"]["throwaway_metric.split"] == res["metrics"]["throwaway_metric"]
    assert set(res["metrics"]) == {"job_s", "setup_s", "throwaway_metric",
                                   "throwaway_metric.split"}
    after = digest(root / "benchmark")
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {"configs/throwaway_cfg.json",
                                        "traffic/throwaway_mix.json",
                                        "metrics/throwaway_metric.py"}


def run_py(cwd: Path):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", BATCHED,
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300)


def test_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal needs a machine without one")
    proc = run_py(HERE.parent)
    assert proc.returncode != 0 and proc.stdout == ""


def test_run_from_the_benchmark_alone_prints_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and the files under paths."""
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(HERE.parent / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    proc = run_py(tmp_path)
    assert proc.returncode != 0 and proc.stdout == ""


def test_run_on_the_card():
    """On a machine with a card: one short run of the 2^16 cell reads
    correct, with the card's name."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = run_py(HERE.parent)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["kind"] == torch.cuda.get_device_name(0)
    assert list(line)[-1] == "checks"


def test_lazy_control_keeps_values_mod_p():
    p = Curve.from_config(harness.Bench(HERE.parent).config("pallas_2e16")).p
    import inputs
    from reference.check import limb_ints
    vals = [0, 1, 5, p - 1]
    lz = control.lazy_limbs(inputs.mont_limbs(vals, p), p)
    got, bad = limb_ints(lz)
    assert bad == 0 and [v % p for v in got] == [v * (1 << 256) % p for v in vals]
    assert got[0] >= p and got[1] < p and np.asarray(lz).dtype == np.int32
