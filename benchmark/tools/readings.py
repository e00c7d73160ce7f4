#!/usr/bin/env python3
"""Readings of the compared numbers, from which the cells' limits are set.

    python3 benchmark/tools/readings.py --workload <cell> --seeds 1,2,3 --side control

`--side control` puts the reference in the program's place in bfloat16
(the control) and `--side program` runs the program; each seed is one run
of the cell at its own size, in one process, with a window of `--seconds`
(the loop finishes the episode it is in, so each run checks one whole
stretch). Prints one JSON line a seed. The benchmark's own runs never run
the control."""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--side", choices=("program", "control"), required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    sys.path[:] = [str(ROOT)] + [p for p in sys.path if p != str(Path(__file__).parent)]
    import torch
    from benchmark import cells, harness
    from benchmark.reference.step import Reference
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    cell = cells.cell(args.workload)
    config = cells.config(cell["config"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        timed = Reference("cuda:0", bf16=True) if args.side == "control" else None
        r = harness.run_cell(cell, config, [], seed, args.seconds, False, t0, "cuda:0",
                             timed=timed, log=lambda s: print(s, file=sys.stderr))
        print(json.dumps({"workload": args.workload, "side": args.side, "seed": seed,
                          "correct": r["correct"], "seconds": time.perf_counter() - t0,
                          "compared": {k: v["value"] for k, v in r["compared"].items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
