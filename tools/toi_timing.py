#!/usr/bin/env python3
"""Time the port's time-of-impact kernel (K2) of one tree on one GPU.

    python3 tools/toi_timing.py [--tree DIR]

DIR is the root of a checkout of the port (default: this one); its
`box2d_mt_tpu_torch` is imported and its kernels are built into its own
`build/`. The lanes and the timing are this checkout's `chip_smoke.py`
helpers, so two trees are timed the same way on the same lanes: run both
in one call, in turns (parent, change, change, parent).

Lanes: the main path's busiest round (512 x pyramid(10) rolled 60 steps
with continuous collision), 4096 fast boxes against a thin wall, 4096 x
pyramid(10)'s first touching round, and the chain floor (the first with
only its costliest lane active). Each gets K2's device time (graph
replay), its duration alone, the wrapper's host time, the plain version's
time and the bound, whose bytes are benchmark/roofline.py's count (see
`chip_smoke.measure` and `time_toi`). The last line is one JSON object.
"""

import argparse
import concurrent.futures
import importlib.util
import json
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(HERE))
    tree = pathlib.Path(ap.parse_args().tree).resolve()
    sys.path.insert(0, str(tree))
    spec = importlib.util.spec_from_file_location("smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import torch
    if not torch.cuda.is_available():
        print("toi_timing: no CUDA device", file=sys.stderr)
        return 2
    from box2d_mt_tpu_torch import cuda_build
    if pathlib.Path(cuda_build.__file__).resolve().parents[1] != tree:
        raise AssertionError(f"imported {cuda_build.__file__}, not the tree {tree}")
    with concurrent.futures.ThreadPoolExecutor(len(smoke.SOURCES)) as pool:
        list(pool.map(cuda_build.build, smoke.SOURCES))
    dev = torch.device("cuda", 0)
    card = smoke.card_line()
    print(f"card: {card}; tree {tree}")

    rec = smoke.Recorder()
    smoke.roll(smoke.batch(10, 512, dev), 60, toi=rec.time_of_impact)
    lanes_main = rec.busiest_toi()
    del rec
    out = {"card": card, "tree": str(tree), "floor_ms": smoke.launch_floor()["ms"]}
    for key, label, lanes in (
            ("main", "512 x pyramid(10), main path's busiest round", lanes_main),
            ("fast", "4096 fast boxes vs a thin wall",
             smoke.capture_toi(smoke.fast_box_worlds(4096, dev), 1)),
            ("4096", "4096 x pyramid(10), first touching round",
             smoke.capture_toi(smoke.batch(10, 4096, dev), 30)),
            ("chain", "chain floor", smoke.costliest_lane(lanes_main))):
        smoke.compare_toi(lanes, label, phase="t", min_touching=0)
        r = smoke.time_toi(lanes, label, phase="t")
        out[key] = {k: r[k] for k in ("ms", "profiler_ms", "host_ms", "plain_ms",
                                      "lanes", "active")}
        out[key]["bound_ms"] = r["bound"][0]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
