"""Run one cell of the benchmark of the PyTorch/CUDA port once, on the card.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is one JSON
object: correct, attempted, failed, metrics (the cell's end-to-end metrics,
or with --trace 1 its per-layer ones), device, with --trace 1 breakdown,
and last the checks, each number the comparison read with its limit; the
same checks are the last lines of standard error.  Without a card, with
fewer cards than the cell asks for, or with JAX or the JAX package loaded
once the window has closed, it prints no result and exits non-zero."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT)]
# every build and kernel cache at a fixed path inside the checkout (the
# program builds its kernels into build/ itself)
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    import harness

    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    bench = harness.Bench(ROOT)
    chips = bench.workload(args.workload)["chips"]
    if torch.cuda.device_count() < chips:
        print(f"the cell asks for {chips} cards, {torch.cuda.device_count()} found",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    result, counts = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                                      bool(args.trace), "cuda", T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": result.pop("memory_peak_bytes")}
    if args.trace:
        device["busy_s"] = result.pop("busy_s")
        device["window_s"] = result.pop("window_s")
    line = {k: result[k] for k in ("correct", "attempted", "failed", "metrics")}
    line["device"] = device
    if args.trace:
        line["breakdown"] = result["breakdown"]
    line["checks"] = {k: {"value": v, "limit": harness.LIMITS[k]} for k, v in counts.items()}
    for text in harness.check_lines(counts):
        print(text, file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
