#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper card.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and the sources of this checkout; exits non-zero
without a card, and on any failed build, failed launch or mismatch.  It

  1. prints the card's name and power limit (nvidia-smi),
  2. builds the kernel library from halo2_liam_eagen_msm_tpu_torch/ops/csrc/,
  3. holds each of the six kernels against its plain PyTorch version on the
     card: torch.equal on every output (integer arithmetic, tolerance zero),
     on seeded inputs with edge lanes, at a ragged size and at the shape the
     main path gives it, and times both there; and checks that the curve
     ops without a kernel yet raise on a CUDA tensor,
  4. drives the main path: best_multiexp on the Pallas curve at 2^20 points
     with full-width scalars (64 random base points tiled, as the headline
     benchmark makes them), checks the result against the exact Python-int
     oracle, and checks that every kernel was launched in that run,
  5. prints one JSON line describing the kernels and, last, one JSON line
     {"ok": true, "device": {...}}.

Each kernel's bound is the least time the card could take for the same work:
the larger of bytes moved (each input read once, each output written once)
over 3.35 TB/s, and 32-bit integer operations over 33.5 TOP/s.  The card's
data sheet states no int32 rate; an SM has 64 int32 lanes beside its 128
float32 lanes, so the rate is taken as half the 67 TFLOP/s float32 figure
(one multiply-add = 2 operations).  A field product counts 136 multiply-adds
(8x8 for a*b, 8x8 for m*p, 8 for m), a field add/sub 8 word additions.
"""

from __future__ import annotations

import argparse
import json
import random
import subprocess
import sys
import time

import numpy as np
import torch

from halo2_liam_eagen_msm_tpu_torch.convert import JPoint, limbs_from_numpy
from halo2_liam_eagen_msm_tpu_torch.fields import PALLAS, N_LIMBS
from halo2_liam_eagen_msm_tpu_torch.limbs import ints_to_mont_limbs
from halo2_liam_eagen_msm_tpu_torch.ops import cuda_ff as CF
from halo2_liam_eagen_msm_tpu_torch.ops import msm as M
from halo2_liam_eagen_msm_tpu_torch.ops.ec import ec
from halo2_liam_eagen_msm_tpu_torch.utils import pyref

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12
MUL_OPS = 2 * 136   # one field product, as operations
ADD_OPS = 8         # one field add/sub/double
ROW_BYTES = 4 * N_LIMBS
SPIN_CYCLES_PER_S = 2.0e9  # upper estimate of the card's clock, for the spin kernel

SOURCE = "halo2_liam_eagen_msm_tpu_torch/ops/csrc/kernels.cu"
PALLAS_FF = "halo2_liam_eagen_msm_tpu/ops/pallas_ff.py"
# kernel -> (line of the TPU kernel's function, field products, field adds,
#            rows read + written per element)
KERNEL_TABLE = {
    "mont_mul": (515, 1, 0, 3),
    "mont_addsub": (541, 0, 1, 3),
    "ec_add": (568, 23, 21, 9),
    "ec_add_fast": (630, 16, 7, 9),
    "ec_double": (832, 7, 14, 6),
    "fused_madd_scan_xyzz": (740, 10, 7, 5),  # per packed row: 1 in, 4 out
}
CURVE = PALLAS
SPEC = PALLAS.field


class Failure(Exception):
    pass


def require(ok: bool, what: str) -> None:
    if not ok:
        raise Failure(what)
    print(f"  ok   {what}", flush=True)


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_ms(dev, fn, reps: int):
    """(device ms, call ms) of fn(), each a mean over `reps` calls after one
    warm-up.  Call ms is the host clock around back-to-back calls, so it
    includes the wrapper's own work.  Device ms is taken with CUDA events
    while a spin kernel holds the card busy until every call is enqueued, so
    the launches run back to back and the host's pace drops out.  Off the
    card (a rehearsal) both are the host clock."""
    fn()
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync(dev)
    call_ms = (time.perf_counter() - t0) * 1e3 / reps
    if dev.type != "cuda":
        return call_ms, call_ms
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # spin for about twice as long as the host needs to enqueue the calls
    torch.cuda._sleep(int(2 * reps * call_ms * 1e-3 * SPIN_CYCLES_PER_S) + 1_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / reps, call_ms


def bound_ms(name: str, elems: int, extra_bytes: int = 0):
    _, muls, adds, rows = KERNEL_TABLE[name]
    t_bytes = (elems * rows * ROW_BYTES + extra_bytes) / HBM_BYTES_PER_S
    t_ops = elems * (muls * MUL_OPS + adds * ADD_OPS) / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# seeded inputs
# ---------------------------------------------------------------------------

def random_field(nprng, b: int, dev):
    """b random reduced field elements as limbs (below 2^254 < p)."""
    a = nprng.integers(0, 1 << 16, size=(b, N_LIMBS), dtype=np.uint32)
    a[:, 15] &= 0x3FFF
    return limbs_from_numpy(a, dev)


def field_inputs(nprng, b: int, dev):
    a, c = random_field(nprng, b, dev), random_field(nprng, b, dev)
    edge_a = ints_to_mont_limbs([0, SPEC.p - 1, 1, 0], SPEC)
    edge_c = ints_to_mont_limbs([SPEC.p - 1, SPEC.p - 1, SPEC.p - 1, 0], SPEC)
    k = min(b, 4)
    a[:k] = limbs_from_numpy(edge_a[:k], dev)
    c[:k] = limbs_from_numpy(edge_c[:k], dev)
    return a, c


def random_points(nprng, base_pts, b: int, dev):
    """b valid points: base points drawn at random, each with its own random
    Jacobian representative (x l^2, y l^3, l).  Returns (points, the index of
    each lane's base point)."""
    bx = limbs_from_numpy(ints_to_mont_limbs([p[0] for p in base_pts], SPEC), dev)
    by = limbs_from_numpy(ints_to_mont_limbs([p[1] for p in base_pts], SPEC), dev)
    idx = torch.from_numpy(nprng.integers(0, len(base_pts), size=b)).to(dev)
    lam = random_field(nprng, b, dev)
    lam[:, 0] |= 1  # never zero
    mul = lambda u, v: CF.mont_mul_plain(SPEC, u, v)
    l2 = mul(lam, lam)
    return JPoint(mul(bx[idx], l2), mul(by[idx], mul(l2, lam)), lam), idx


def curve_inputs(nprng, base_pts, b: int, dev):
    """Two batches of b points with the edge lanes 0..4: p identity, q
    identity, both identity, q == p (doubling), q == -p (inverse).  Returns
    (p, q, host points of p, host points of q) with the host lists covering
    the first min(b, 64) lanes."""
    (p, ip), (q, iq) = random_points(nprng, base_pts, b, dev), \
        random_points(nprng, base_pts, b, dev)
    p = JPoint(*(c.clone() for c in p))
    q = JPoint(*(c.clone() for c in q))
    k = min(b, 64)
    hp = [base_pts[i] for i in ip[:k].tolist()]
    hq = [base_pts[i] for i in iq[:k].tolist()]
    if b >= 5:
        p.z[0] = 0
        q.z[1] = 0
        p.z[2] = 0
        q.z[2] = 0
        for c_p, c_q in zip(p, q):
            c_q[3] = c_p[3]
            c_q[4] = c_p[4]
        q.y[4] = CF.mont_addsub_plain(SPEC, True, torch.zeros_like(q.y[4]), q.y[4])
        hp[0] = None
        hq[1] = None
        hp[2] = hq[2] = None
        hq[3] = hp[3]
        hq[4] = pyref.ec_neg(hp[4], CURVE)
    return p, q, hp, hq


def scan_rows(nprng, base_pts, g: int, w: int, dev):
    """g*w packed affine rows: tiled base points with zero rows (affine
    identities) in the stream, and lane 5 starting with -T, which must flag
    that lane and no other."""
    E = ec(CURVE)
    pts = list(base_pts) + [pyref.ec_neg(E.offset_point_ints(), CURVE)]
    ax = limbs_from_numpy(ints_to_mont_limbs([p[0] for p in pts], SPEC), dev)
    ay = limbs_from_numpy(ints_to_mont_limbs([p[1] for p in pts], SPEC), dev)
    table = torch.cat([M._pack_pair(ax, ay), torch.zeros_like(ax[:1])])  # last: zero row
    n = g * w
    idx = nprng.integers(0, len(base_pts), size=n)
    idx[nprng.random(n) < 0.05] = len(pts)      # zero rows
    idx[5 * w] = len(base_pts)                  # -T at the head of lane 5
    return table[torch.from_numpy(idx).to(dev)].contiguous()


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

def outputs_equal(got, want) -> int:
    """Largest absolute difference over all outputs (0 means identical)."""
    worst = 0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            raise Failure(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        if not torch.equal(g, w):
            worst = max(worst, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
    return worst


def flatten_outs(out):
    flat = []
    for o in out:
        flat.extend(o if isinstance(o, tuple) else [o])
    return flat


def check_kernel(dev, name, kernel, plain, make_inputs, sizes, reps, elems_of=None,
                 extra_bytes_of=None, host_check=None):
    """Compare kernel and plain version at every size; time both at the last
    (the main-path shape).  Returns the kernel's record for the JSON line."""
    print(f"kernel {name}", flush=True)
    worst = 0
    for size in sizes:
        args = make_inputs(size)
        got = flatten_outs(kernel(*args))
        sync(dev)
        t0 = time.perf_counter()
        want = flatten_outs(plain(*args))
        sync(dev)
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = outputs_equal(got, want)
        worst = max(worst, err)
        require(err == 0, f"{name} equals {name}_plain at size {size} "
                          f"({len(got)} outputs, max abs diff {err})")
        if host_check is not None:
            host_check(size, args, got)
    ms, call_ms = time_ms(dev, lambda: kernel(*args), reps)
    elems = elems_of(size) if elems_of else size
    extra = extra_bytes_of(size) if extra_bytes_of else 0
    b_ms, b_by = bound_ms(name, elems, extra)
    line = KERNEL_TABLE[name][0]
    rec = {"name": name, "route": "cuda", "source": SOURCE,
           "replaces": f"{PALLAS_FF}:{line}", "launches": 0, "max_abs_err": worst,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": None, "shape": str(size), "call_ms": call_ms}
    print(f"  time {name} at {size}: kernel {ms:.4f} ms on the device, {call_ms:.4f} ms "
          f"a call on the host, plain {plain_ms:.1f} ms, bound {b_ms:.5f} ms ({b_by})",
          flush=True)
    return rec


def check_kernels(dev, base_pts, ragged: int, shapes: dict, scan_small_g: int, reps: int):
    nprng = np.random.default_rng(0xC0FFEE)
    E = ec(CURVE)
    recs = []

    recs.append(check_kernel(
        dev, "mont_mul",
        lambda a, b: (CF.mont_mul(SPEC, a, b),),
        lambda a, b: (CF.mont_mul_plain(SPEC, a, b),),
        lambda b: field_inputs(nprng, b, dev), [ragged, shapes["mont_mul"]], reps))

    def addsub(fn):
        return lambda a, b: (fn(SPEC, False, a, b), fn(SPEC, True, a, b))
    rec = check_kernel(
        dev, "mont_addsub", addsub(CF.mont_addsub), addsub(CF.mont_addsub_plain),
        lambda b: field_inputs(nprng, b, dev), [ragged, shapes["mont_addsub"]], reps)
    for key in ("ms", "call_ms", "plain_ms"):  # the timed call launches twice (add, sub)
        rec[key] /= 2
    recs.append(rec)

    host = {}

    def two_points(b):
        p, q, hp, hq = curve_inputs(nprng, base_pts, b, dev)
        host["p"], host["q"] = hp, hq
        return (*p, *q)

    def vs_pyref_add(size, args, got):
        k = len(host["p"])
        pts = E.points_to_ints(JPoint(*(c[:k] for c in got[:3])))
        want = [pyref.ec_add(a, b, CURVE) for a, b in zip(host["p"], host["q"])]
        if len(got) == 4:  # fast add: doubling lanes are flagged, not computed
            doubling = [a is not None and a == b for a, b in zip(host["p"], host["q"])]
            require(got[3][:k].tolist() == doubling and doubling[3],
                    f"ec_add_fast flags exactly the doubling lanes at size {size}")
            pts = [w if d else g for g, w, d in zip(pts, want, doubling)]
        require(pts == want, f"first {k} lanes equal the Python-int oracle at size {size}")

    recs.append(check_kernel(
        dev, "ec_add", lambda *a: CF.ec_add(CURVE, *a), lambda *a: CF.ec_add_plain(CURVE, *a),
        two_points, [ragged, shapes["ec_add"]], reps, host_check=vs_pyref_add))
    recs.append(check_kernel(
        dev, "ec_add_fast", lambda *a: CF.ec_add_fast(CURVE, *a),
        lambda *a: CF.ec_add_fast_plain(CURVE, *a),
        two_points, [ragged, shapes["ec_add_fast"]], reps,
        extra_bytes_of=lambda b: b, host_check=vs_pyref_add))

    def one_point(b):
        p, _, hp, _ = curve_inputs(nprng, base_pts, b, dev)
        host["p"] = hp
        return tuple(p)

    def vs_pyref_double(size, args, got):
        k = len(host["p"])
        pts = E.points_to_ints(JPoint(*(c[:k] for c in got)))
        require(pts == [pyref.ec_add(a, a, CURVE) for a in host["p"]],
                f"first {k} lanes equal the Python-int oracle at size {size}")

    recs.append(check_kernel(
        dev, "ec_double", lambda *a: CF.ec_double(CURVE, *a),
        lambda *a: CF.ec_double_plain(CURVE, *a),
        one_point, [ragged, shapes["ec_double"]], reps, host_check=vs_pyref_double))

    w = CF.SCAN_W
    xi, yi = E.offset_point_ints()
    t_limbs = tuple(tuple(int(v) for v in ints_to_mont_limbs([c], SPEC)[0]) for c in (xi, yi))

    def scan_flags(g, args, got):
        flags = got[8].nonzero().flatten().tolist()
        require(flags == [5], f"the scan flags lane 5 (first row -T) and no other at g = {g}")

    recs.append(check_kernel(
        dev, "fused_madd_scan_xyzz",
        lambda rows: CF.fused_madd_scan_xyzz(CURVE, t_limbs, rows, w),
        lambda rows: CF.fused_madd_scan_xyzz_plain(CURVE, t_limbs, rows, w),
        lambda g: (scan_rows(nprng, base_pts, g, w, dev),),
        [scan_small_g, shapes["fused_madd_scan_xyzz"]], max(1, reps // 10),
        elems_of=lambda g: g * w, extra_bytes_of=lambda g: g * (4 * ROW_BYTES + 1),
        host_check=scan_flags))
    return recs


def check_unported_ops_raise(dev) -> None:
    """The two curve ops whose kernels are still to be ported raise on a CUDA
    tensor and name the kernel; nothing falls back to the plain version."""
    print("ops without a kernel yet", flush=True)
    E = ec(CURVE)
    p = E.generator((4,), dev)
    qid = torch.zeros(4, dtype=torch.bool, device=dev)
    for what, call in (("ec_add_mixed", lambda: E.add_mixed(p, p.x, p.y, qid)),
                       ("ec_madd_xyzz_fast",
                        lambda: E.madd_xyzz_fast(p.x, p.y, p.z, p.z, p.x, p.y))):
        try:
            call()
        except NotImplementedError as e:
            require(what in str(e), f"{what} raises NotImplementedError on a CUDA tensor")
        else:
            raise Failure(f"{what} did not raise on a CUDA tensor")


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def main_path(dev, base_pts, logn: int):
    """best_multiexp at 2^logn Pallas points, full-width scalars, against the
    exact oracle.  Returns (best seconds of three timed runs, launch counts of
    the first of them, the inputs)."""
    n = 1 << logn
    distinct = len(base_pts)
    reps = n // distinct
    print(f"main path: best_multiexp, Pallas, n = 2^{logn}, 255-bit scalars, "
          f"c = {M.pick_window(n)}", flush=True)
    xs = ints_to_mont_limbs([p[0] for p in base_pts], SPEC)
    ys = ints_to_mont_limbs([p[1] for p in base_pts], SPEC)
    pts = JPoint(limbs_from_numpy(np.tile(xs, (reps, 1)), dev),
                 limbs_from_numpy(np.tile(ys, (reps, 1)), dev),
                 limbs_from_numpy(np.tile(ints_to_mont_limbs([1], SPEC), (n, 1)), dev))
    nprng = np.random.default_rng(0xBE7C)
    sc = nprng.integers(0, 1 << 16, size=(n, N_LIMBS), dtype=np.uint32)
    sc[:, 15] &= 0x3FFF  # full-width scalars below 2^254 < q
    scalars = limbs_from_numpy(sc, dev)

    # oracle: the points are tiled, so sum_i s_i P_i = sum_j (sum_{i = j mod
    # 64} s_i mod q) B_j, a 64-point MSM in Python ints
    q = CURVE.scalar_field.p
    limb_sums = sc.astype(np.int64).reshape(reps, distinct, N_LIMBS).sum(axis=0)
    folded = [sum(int(v) << (16 * k) for k, v in enumerate(row)) % q for row in limb_sums]
    want = pyref.ec_msm(folded, base_pts, CURVE)

    E = ec(CURVE)
    c = M.pick_window(n)
    bits = q.bit_length()
    # warm-up through the fast flavor itself, to read its exception flag
    res, exc = M._best_multiexp(CURVE, c, bits, "fast", scalars, pts)
    require(not bool(exc), "the fast flavor's exception flag is clear")
    got = E.points_to_ints(JPoint(*(cc[None] for cc in res)))[0]
    require(got == want, "warm-up result equals the Python-int oracle (affine)")

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    CF.reset_launch_counts()
    sync(dev)
    t0 = time.perf_counter()
    res = M.best_multiexp(CURVE, scalars, pts)
    sync(dev)
    runs = [time.perf_counter() - t0]
    counts = dict(CF.LAUNCHES)
    if dev.type == "cuda":
        print(f"  peak device memory of one MSM: "
              f"{torch.cuda.max_memory_allocated(dev) / 2**20:.0f} MiB", flush=True)
    got = E.points_to_ints(JPoint(*(cc[None] for cc in res)))[0]
    require(got == want, "timed result equals the Python-int oracle (affine)")
    for name in CF.KERNELS:
        require(counts[name] > 0, f"{name} was launched on the main path ({counts[name]} times)")
    for _ in range(2):  # the path is paced by the host: show the spread
        t0 = time.perf_counter()
        M.best_multiexp(CURVE, scalars, pts)
        sync(dev)
        runs.append(time.perf_counter() - t0)
    seconds = min(runs)
    print("  best_multiexp: runs of " + ", ".join(f"{r:.4f}" for r in runs)
          + f" s; best {seconds:.4f} s, {n / seconds:.1f} points/s", flush=True)
    return seconds, counts, (scalars, pts)


def profile_main_path(dev, scalars, pts) -> None:
    """Optional (--profile): device time by kernel over one best_multiexp."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        M.best_multiexp(CURVE, scalars, pts)
        sync(dev)
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--logn", type=int, default=20, help="log2 of the MSM size")
    ap.add_argument("--profile", action="store_true",
                    help="also print a torch.profiler table of one MSM")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs a card",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)

    CF.build_library()
    print(f"build: {CF.BUILD_INFO['path']} in {CF.BUILD_INFO['seconds']:.1f} s", flush=True)
    entry = ""
    for ln in CF.BUILD_INFO.get("ptxas", "").splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1]
        elif "registers" in ln or "spill" in ln:
            print(f"  ptxas {entry}: {ln.split(':', 1)[-1].strip()}", flush=True)

    base_pts = pyref.random_points(random.Random(0xBE7C), CURVE, 64)
    n = 1 << args.logn
    g = max(1, n // CF.SCAN_W)
    nb = 1 << M.pick_window(n)
    shapes = {"mont_mul": n, "mont_addsub": nb, "ec_add": min(g, 2048),
              "ec_add_fast": nb, "ec_double": 1, "fused_madd_scan_xyzz": g}
    recs = check_kernels(dev, base_pts, ragged=5000, shapes=shapes,
                         scan_small_g=2050, reps=50)

    check_unported_ops_raise(dev)

    seconds, counts, (scalars, pts) = main_path(dev, base_pts, args.logn)
    for rec in recs:
        rec["launches"] = counts[rec["name"]]
        print(f"  {rec['name']}: {rec['launches']} launches, {rec['ms']:.4f} ms each "
              f"on the device at shape {rec['shape']}", flush=True)
    if args.profile:
        profile_main_path(dev, scalars, pts)

    print(f"msm: n = {n}, seconds = {seconds}, points_per_s = {n / seconds}, card = {card}",
          flush=True)
    print(json.dumps({"kernels": recs}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
