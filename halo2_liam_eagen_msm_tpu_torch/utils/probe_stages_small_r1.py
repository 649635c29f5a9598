"""Probe of stages_small's 1-bit window (R = 1) on the card.

    python3 -m halo2_liam_eagen_msm_tpu_torch.utils.probe_stages_small_r1 [--tiles 8 ...]
        [--timeout 60]

The launcher of the path takes R = 1 at a tile of 2 alone: from a tile of 8
up it hung on the card when it was tried (PERF.md section 7).  This builds
the kernel library, then for each tile starts a child process that makes one
launch of the R = 1 instantiation (ops/cuda_ntt.stages_small_r1, through the
test-only launcher) forward at that tile over 4,096 elements, synchronises,
and compares the result with the plain stages (stages_small_plain); it says
when everything before the launch is done, so a hang is placed.  The
parent waits at most --timeout seconds for the child and kills it past that.
One JSON line a tile: {"tile", "outcome": "matched", "differed", "faulted"
or "hung", "seconds", "detail"}, and a last line with the card's name and
power limit.  Exits 0 when every tile matched.  Needs a card; no path runs
it.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

E = 4096  # elements a launch: four blocks of 1024


def child(tile: int) -> int:
    import numpy as np
    import torch

    from ..fields import PALLAS
    from ..ops import cuda_ff as CF
    from ..ops import cuda_ntt as CN

    spec = PALLAS.field
    dev = torch.device("cuda", 0)
    logn = tile.bit_length() - 1
    x = np.random.default_rng(tile).integers(0, 1 << 16, size=(16, E), dtype=np.int64)
    x[15] &= 0x3FFF  # below 2^254 < p: reduced
    x = torch.from_numpy(x.astype(np.int32)).to(dev)
    tw = CN.tables(spec, logn, False, dev)
    CF._lib()  # the library loaded
    torch.cuda.synchronize(dev)
    print(json.dumps({"ready": True}), flush=True)  # everything before the launch done
    got = CN.stages_small_r1(spec, x, tile, False, tw)
    torch.cuda.synchronize(dev)
    want = CN.stages_small_plain(spec, x, tile, False, tw)
    print(json.dumps({"equal": bool(torch.equal(got, want))}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tiles", type=int, nargs="+", default=[8])
    ap.add_argument("--timeout", type=float, default=60.0)
    ap.add_argument("--child", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        return child(args.child)

    import torch

    from ..ops import cuda_ff as CF

    if not torch.cuda.is_available():
        print("probe_stages_small_r1: no card", file=sys.stderr)
        return 1
    CF.build_library()  # in the parent: the children only load it
    ok = True
    for tile in args.tiles:
        t0 = time.perf_counter()
        cmd = [sys.executable, "-m", __spec__.name, "--child", str(tile)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=args.timeout)
        except subprocess.TimeoutExpired as e:  # run() kills the child
            said = e.stdout.decode() if isinstance(e.stdout, bytes) else e.stdout or ""
            where = ("in the launch or its synchronize (the inputs made and the library "
                     "loaded before it)" if "ready" in said else "before the launch")
            rec = {"outcome": "hung", "detail": f"no exit within {args.timeout} s, {where}; "
                                                f"killed"}
        else:
            if proc.returncode != 0:
                rec = {"outcome": "faulted",
                       "detail": f"exit {proc.returncode}: {proc.stderr.strip()[-600:]}"}
            else:
                equal = json.loads(proc.stdout.strip().splitlines()[-1])["equal"]
                rec = {"outcome": "matched" if equal else "differed",
                       "detail": f"E = {E}, forward, against stages_small_plain"}
        rec = {"tile": tile, **rec, "seconds": time.perf_counter() - t0}
        ok = ok and rec["outcome"] == "matched"
        print(json.dumps(rec), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
