"""The control of the comparison that decides `correct`, and a sweep of
seeds, in one process: not part of any benchmark run.

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 --seconds <s>

For each seed it runs the cell (set-up, a window of `seconds`, the check)
and prints the program's readings; then it rewrites the outputs the window
kept as the control would have produced them and checks them again.

The control breaks one guarantee the configurations state, the step that
would tempt a later change: every output fully reduced.  A Montgomery
product without its final conditional subtraction leaves its result in
[0, 2p); the control leaves every other value of every kept output there
(v + p for v below p: same value mod p, limbs that differ), as such a lazy
reduction would.  The comparison is exact on limbs, so the control has to
read as not correct."""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

import numpy as np  # noqa: E402


def lazy_limbs(arr: np.ndarray, p: int) -> np.ndarray:
    """(..., 16) limbs with every other value v -> v + p."""
    flat = np.asarray(arr).reshape(-1, 16).astype(np.int64)
    if flat.shape[0] == 0:
        return arr
    p_limbs = np.array([(p >> (16 * i)) & 0xFFFF for i in range(16)], dtype=np.int64)
    out = flat.copy()
    sel = out[::2] + p_limbs
    for i in range(15):
        sel[:, i + 1] += sel[:, i] >> 16
        sel[:, i] &= 0xFFFF
    out[::2] = sel
    return out.astype(np.int32).reshape(np.asarray(arr).shape)


def lazy(p: int):
    """The control as a rewrite of a job's kept outputs (host arrays)."""
    def walk(x):
        if isinstance(x, np.ndarray):
            return lazy_limbs(x, p) if x.ndim and x.shape[-1] == 16 else x
        if isinstance(x, tuple):
            return tuple(walk(v) for v in x)
        if isinstance(x, list):
            return [walk(v) for v in x]
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        return x

    def control(job):
        job.kept = walk(job.kept)
    return control


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    import harness
    from reference.curve import Curve

    bench = harness.Bench(HERE.parent)
    cfg = bench.config(bench.workload(args.workload)["config"])
    p = Curve.from_config(cfg).p
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        res, counts = harness.run_cell(bench, args.workload, seed, args.seconds, False,
                                       control=lazy(p))
        ctl = res["control_checks"]
        print(json.dumps({"seed": seed, "correct": res["correct"], "attempted": res["attempted"],
                          "checks": dict(counts), "control_correct": ctl.correct,
                          "control_checks": dict(ctl), "metrics": res["metrics"],
                          "memory_peak_bytes": res["memory_peak_bytes"],
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
