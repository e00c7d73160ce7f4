#!/usr/bin/env python3
"""Time the port's solve-middle kernels (K1, and K4-K6 of the sandwich) of
one tree on one GPU.

    python3 tools/middle_timing.py [--tree DIR]

DIR is the root of a checkout of the port (default: this one); its
`box2d_mt_tpu_torch` is imported and its kernels are built into its own
`build/`. The inputs and the timing are this checkout's `chip_smoke.py`
helpers, so two trees are timed the same way on the same inputs: run both
in one call, in turns (parent, change, change, parent).

Inputs: K1's of the last step of 512 x pyramid(10) rolled 60 steps (its
resident path) and of 16 x pyramid(44) rolled 60 steps (its ring path);
K4, K5 and K6's of the busiest step of 256 x tumbler(200) rolled 60
steps. Each gets its device time (20 launches in a CUDA graph, replayed;
`chip_smoke.device_time`). The last line is one JSON object.
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
        print("middle_timing: no CUDA device", file=sys.stderr)
        return 2
    from box2d_mt_tpu_torch import cuda_build
    from box2d_mt_tpu_torch.ops import solve_middle as sm
    if pathlib.Path(cuda_build.__file__).resolve().parents[1] != tree:
        raise AssertionError(f"imported {cuda_build.__file__}, not the tree {tree}")
    with concurrent.futures.ThreadPoolExecutor(len(smoke.SOURCES)) as pool:
        list(pool.map(cuda_build.build, smoke.SOURCES))
    dev = torch.device("cuda", 0)
    card = smoke.card_line()
    print(f"card: {card}; tree {tree}")
    out = {"card": card, "tree": str(tree)}
    for key, rows, n_worlds in (("k1_pyramid10_512", 10, 512), ("k1_pyramid44_16", 44, 16)):
        rec = smoke.Recorder()
        smoke.roll(smoke.batch(rows, n_worlds, dev), 60, middle=rec.solve_middle)
        out[key] = smoke.device_time(sm.solve_middle, rec.middle)
        print(f"{key}: K1 {out[key]:.4f} ms on the device")
    rec = smoke.SandwichRecorder()
    smoke.roll(smoke.joint_batch("tumbler", 200, 256, dev), 60, sandwich=rec.hook())
    first = smoke.compare_sandwich(rec.busiest(), "256 x tumbler(200)", phase="t")
    for name in ("vel_iter_packed", "pos_iter_packed", "unpack_packed"):
        out[f"{name}_tumbler_256"] = smoke.device_time(getattr(sm, name), first[name])
        print(f"{name}: {out[f'{name}_tumbler_256']:.4f} ms on the device")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
