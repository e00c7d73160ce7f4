#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the card it is started on.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints earlier lines of context, the compared numbers beside their limits
as the last lines on standard error, and one JSON object as the last line
of standard output. Exits with a code other than 0, and prints no result,
without enough CUDA devices or when the run loaded JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # build and kernel caches at fixed paths inside the checkout
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    # load from one process with few threads: the step launches from one
    # thread, and idle OpenMP workers would only contend for the host's cores
    os.environ["OMP_NUM_THREADS"] = "1"
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [str(ROOT)] + [p for p in sys.path if p != here]
    from benchmark import harness
    return harness.main(args, T_START)


if __name__ == "__main__":
    sys.exit(main())
