#!/usr/bin/env python3
"""Time the port's whole step of one tree on one GPU.

    python3 tools/step_timing.py [--tree DIR]

DIR is the root of a checkout of the port (default: this one); its
`box2d_mt_tpu_torch` is imported and its kernels are built into its own
`build/`. The rolls and the timing are this checkout's `chip_smoke.py`
helpers, so two trees are timed the same way: run both in one call, in
turns (parent, change, change, parent).

The main path, 512 x pyramid(10) x 60 steps with continuous collision
(chip_smoke's settings), gives worlds*steps/s, host syncs a step, CUDA
kernels a step (three profiled steps after the roll) and a synchronized
split of five more steps into the collide phase, the solve middle and the
TOI phase. A tree whose scenes have `sphere_stack` gets the same for 512 x
sphere_stack(10) x 120 steps. The last line is one JSON object.
"""

import argparse
import concurrent.futures
import importlib.util
import json
import pathlib
import sys
import time

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
        print("step_timing: no CUDA device", file=sys.stderr)
        return 2
    from box2d_mt_tpu_torch import cuda_build
    from box2d_mt_tpu_torch.models import scenes
    if pathlib.Path(cuda_build.__file__).resolve().parents[1] != tree:
        raise AssertionError(f"imported {cuda_build.__file__}, not the tree {tree}")
    with concurrent.futures.ThreadPoolExecutor(len(smoke.SOURCES)) as pool:
        list(pool.map(cuda_build.build, smoke.SOURCES))
    dev = torch.device("cuda", 0)
    card = smoke.card_line()
    print(f"card: {card}; tree {tree}")
    out = {"card": card, "tree": str(tree)}
    cells = [("pyramid", 10, 60)]
    if hasattr(scenes, "sphere_stack"):
        cells.append(("sphere_stack", 10, 120))
    for scene, size, n_steps in cells:
        smoke.roll(smoke.joint_batch(scene, size, 512, dev), 14)      # first-use allocations
        states = smoke.joint_batch(scene, size, 512, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        states, syncs = smoke.roll(states, n_steps)
        torch.cuda.synchronize()
        ws = 512 * n_steps / (time.perf_counter() - t0)
        per_step = smoke.kernels_per_step(states)
        split = smoke.phase_split(states)
        label = f"512 x {scene}({size}) x {n_steps} steps"
        print(f"{label}, continuous=True: {ws:.1f} worlds*steps/s, host syncs/step="
              f"{syncs / n_steps:.2f}, CUDA kernels+copies/step={per_step}; the next 5 "
              f"steps: {split}")
        out[scene] = {"worlds_steps_per_s": ws, "host_syncs_per_step": syncs / n_steps,
                      "kernels_per_step": per_step, "split": split}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
