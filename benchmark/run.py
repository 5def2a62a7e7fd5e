"""One run of one benchmark cell.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

Run from the root of a checkout on a machine with the cards the cell asks
for; prints the result as one JSON line, last on standard output, and the
numbers compared with the reference, each beside its limit, last on
standard error. Exits non-zero, printing no result, without the cards."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    if a.seed < 0:
        ap.error("--seed must be >= 0")
    # a kernel cache the program may come to keep (Triton, torch
    # extensions) goes inside the checkout, at a fixed path
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ.setdefault(var, str(ROOT / ".bench_cache" / sub))
    sys.path.insert(0, str(ROOT))
    from benchmark.harness.main import run

    result = run(a.workload, a.seed, a.seconds, bool(a.trace),
                 t_start=T_START)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
