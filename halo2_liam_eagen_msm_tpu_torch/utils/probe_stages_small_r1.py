"""Probe of stages_small's 1-bit window (R = 1) on the card.

    python3 -m halo2_liam_eagen_msm_tpu_torch.utils.probe_stages_small_r1
        [--tiles 2 4 ... 1024] [--timeout 120]

The launcher of the path takes R = 1 at a tile of 2 alone.  When its window
loop stepped its index down with a test of both ends, the R = 1 forward
launch hung on the card from a tile of 4 up (PERF.md section 7); the loop is
a count now.  This builds the kernel library, then starts one child process
that, for each tile and each direction in turn, makes one launch of the R = 1
instantiation (ops/cuda_ntt.stages_small_r1, through the test-only launcher)
over 4,096 elements, synchronises, and compares the result with the plain
stages (stages_small_plain).  Before each launch the child says which case
it starts, so a hang is placed.  The parent waits at most --timeout seconds
for the child and kills it past that.

probe() returns one record a case, {"tile", "inverse", "outcome": "matched",
"differed", "faulted", "hung" or "not run", "detail"}; run as a module it
prints them as JSON lines, then the card's name and power limit, and exits 0
when every case matched.  chip_smoke.py runs probe() at every tile from 2 to
1024, both ways.  Needs a card; no path runs it.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

E = 4096  # elements a launch: four blocks of 1024
TILES = tuple(1 << k for k in range(1, 11))  # every tile stages_small takes


def child(tiles) -> int:
    import numpy as np
    import torch

    from ..fields import PALLAS
    from ..ops import cuda_ff as CF
    from ..ops import cuda_ntt as CN

    spec = PALLAS.field
    dev = torch.device("cuda", 0)
    CF._lib()  # the library loaded
    for tile in tiles:
        logn = tile.bit_length() - 1
        x = np.random.default_rng(tile).integers(0, 1 << 16, size=(16, E), dtype=np.int64)
        x[15] &= 0x3FFF  # below 2^254 < p: reduced
        x = torch.from_numpy(x.astype(np.int32)).to(dev)
        for inverse in (False, True):
            tw = CN.tables(spec, logn, inverse, dev)
            torch.cuda.synchronize(dev)
            # everything before the launch done
            print(json.dumps({"start": [tile, inverse]}), flush=True)
            got = CN.stages_small_r1(spec, x, tile, inverse, tw)
            torch.cuda.synchronize(dev)
            want = CN.stages_small_plain(spec, x, tile, inverse, tw)
            print(json.dumps({"tile": tile, "inverse": inverse,
                              "equal": bool(torch.equal(got, want))}), flush=True)
    return 0


def probe(tiles=TILES, timeout: float = 120.0) -> list:
    """Every tile of `tiles`, forward then inverse, in one child process under
    `timeout` seconds (start-up included).  The kernel library must be built
    (cuda_ff.build_library()): the child only loads it."""
    cmd = [sys.executable, "-m", __spec__.name, "--child", *map(str, tiles)]
    cases = [(tile, inverse) for tile in tiles for inverse in (False, True)]
    detail = f"E = {E}, against stages_small_plain"
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
        said, end = proc.stdout, (None if proc.returncode == 0 else
                                  f"exit {proc.returncode}: {proc.stderr.strip()[-600:]}")
    except subprocess.TimeoutExpired as e:  # run() kills the child
        said = e.stdout.decode() if isinstance(e.stdout, bytes) else e.stdout or ""
        end = f"no exit within {timeout} s; killed"
    done, started = {}, None
    for line in said.splitlines():
        try:
            rec = json.loads(line)
        except ValueError:  # not one of the child's records
            continue
        if "start" in rec:
            started = tuple(rec["start"])
        else:
            done[(rec["tile"], rec["inverse"])] = rec["equal"]
    out = []
    for case in cases:
        if case in done:
            outcome = "matched" if done[case] else "differed"
            what = detail
        elif case == started:
            outcome = "hung" if end and end.startswith("no exit") else "faulted"
            what = f"{end}, in the launch or its synchronize (the inputs made and the " \
                   f"library loaded before it)"
        else:
            outcome, what = "not run", end or "the child ended before it"
        out.append({"tile": case[0], "inverse": case[1], "outcome": outcome, "detail": what})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tiles", type=int, nargs="+", default=list(TILES))
    ap.add_argument("--timeout", type=float, default=120.0)
    ap.add_argument("--child", type=int, nargs="+", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        return child(args.child)

    import torch

    from ..ops import cuda_ff as CF

    if not torch.cuda.is_available():
        print("probe_stages_small_r1: no card", file=sys.stderr)
        return 1
    CF.build_library()  # in the parent: the child only loads it
    t0 = time.perf_counter()
    recs = probe(args.tiles, args.timeout)
    for rec in recs:
        print(json.dumps(rec), flush=True)
    print(json.dumps({"seconds": time.perf_counter() - t0}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    return 0 if all(r["outcome"] == "matched" for r in recs) else 1


if __name__ == "__main__":
    sys.exit(main())
