#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (box2d_mt_tpu_torch) on one GPU.

Run from the repository root: `python3 chip_smoke.py`. It needs a CUDA
device and the CUDA toolkit (nvcc), builds the port's kernel from
`box2d_mt_tpu_torch/csrc/`, and runs these phases, raising on any failure:

  1. card and build: the `nvidia-smi` card line, the kernel build time;
  2. the solve-middle kernel against its plain PyTorch version on inputs
     captured from the port's own step (64 x pyramid(10) and
     16 x pyramid(44) after 30 steps, and 64 x pyramid(10) recolored with
     max_colors=3 so the overflow color's Jacobi path runs): atol 1e-5 on
     positions, 1e-4 on velocities and impulses, equal convergence
     predicate;
  3. the main path: 512 x pyramid(10) for 60 steps (velocity_iterations=8,
     position_iterations=3, max_colors=16, continuous=False), counting
     kernel launches; no NaN, no color overflow, every box above y = 0.4;
  4. the whole step through the kernel vs through the plain middle on the
     card, 64 x pyramid(10) for 30 steps (c, a to 2e-5, v to 1e-4, awake
     equal);
  5. large worlds: 128 x pyramid(44) (991 boxes) for 20 steps;
  6. sleep: 64 x pyramid(10) until every body sleeps (at most 300 steps),
     then one step that must take the all-asleep skip;
  7. kernel and plain time per call (CUDA events, after warm-up).

The last two lines are the kernels' JSON record and
{"ok": true, "device": {...}}. Nothing is printed as a result, and the
exit code is not 0, when there is no CUDA device.
"""

import dataclasses
import json
import subprocess
import sys
import time

DT = 1.0 / 60.0
MAIN = dict(velocity_iterations=8, position_iterations=3, max_colors=16,
            continuous=False)
REPLACES = "box2d_mt_tpu/ops/pallas_solve.py:273"
SOURCE = "box2d_mt_tpu_torch/csrc/solve_middle.cu"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def batch(rows, n, device):
    from box2d_mt_tpu_torch.models import scenes
    from box2d_mt_tpu_torch.state import replicate
    return replicate(scenes.pyramid(rows, device=device), n)


def roll(states, n_steps, middle=None, check=None):
    """n_steps of the main-path step; `check(states, events)` after each."""
    from box2d_mt_tpu_torch.world import step_batched
    syncs = 0
    for _ in range(n_steps):
        states, ev = step_batched(states, DT, middle=middle, **MAIN)
        syncs += ev.host_syncs
        if check is not None:
            check(states, ev)
    return states, syncs


def capture_middle(states, max_colors=MAIN["max_colors"]):
    """One more step, recording the solve middle's arguments. Returns
    (arguments, max color overflow of that step)."""
    import torch
    from box2d_mt_tpu_torch.ops.solve_middle import solve_middle
    from box2d_mt_tpu_torch.world import step_batched
    got = {}

    def middle(*args):
        got["args"] = args
        return solve_middle(*args)

    if max_colors != MAIN["max_colors"]:
        # recolor with this budget: the color cache does not key on max_colors
        states = dataclasses.replace(states, cache=dataclasses.replace(
            states.cache, valid=torch.zeros_like(states.cache.valid)))
    _, ev = step_batched(states, DT, middle=middle,
                         **dict(MAIN, max_colors=max_colors))
    return got["args"], int(ev.color_overflow.max())


def compare_middle(args, label):
    """Kernel vs plain on the same inputs; returns the max abs error."""
    import torch
    from box2d_mt_tpu_torch import settings
    from box2d_mt_tpu_torch.ops.solve_middle import solve_middle, solve_middle_plain
    k_vel, k_pos, k_aux = solve_middle(*args)
    p_vel, p_pos, p_aux = solve_middle_plain(*args)
    torch.cuda.synchronize()
    err = {"pos": (k_pos - p_pos).abs().max().item(),
           "vel": (k_vel - p_vel).abs().max().item(),
           "impulse": (k_aux[:, :4] - p_aux[:, :4]).abs().max().item()}
    ok_k = k_aux[:, 4] >= -3.0 * settings.LINEAR_SLOP
    ok_p = p_aux[:, 4] >= -3.0 * settings.LINEAR_SLOP
    lanes = int((args[2][:, -1]).sum())
    print(f"phase 2 [{label}] lanes solved={lanes} max|diff| pos={err['pos']:.3g} "
          f"vel={err['vel']:.3g} impulse={err['impulse']:.3g} "
          f"predicate_equal={bool(torch.equal(ok_k, ok_p))}")
    if lanes == 0:
        raise AssertionError(f"{label}: no contact lanes to solve")
    if err["pos"] > 1e-5 or err["vel"] > 1e-4 or err["impulse"] > 1e-4:
        raise AssertionError(f"{label}: kernel disagrees with the plain version: {err}")
    if not torch.equal(ok_k, ok_p):
        raise AssertionError(f"{label}: convergence predicate differs")
    return max(err.values())


def time_call(fn, args, reps=20):
    import torch
    for _ in range(3):
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn(*args)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs a GPU",
              file=sys.stderr)
        return 2
    from box2d_mt_tpu_torch import cuda_build
    from box2d_mt_tpu_torch.ops import solve_middle as sm
    from box2d_mt_tpu_torch.world import step_batched

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}  (torch {torch.__version__}, cuda {torch.version.cuda})")

    # ---- 1. build
    t0 = time.perf_counter()
    info = cuda_build.build("solve_middle")
    print(f"phase 1 build solve_middle: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {info['seconds']:.2f} s)")
    for line in info["log"].splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            print("  ptxas:", line.strip())

    # ---- 2. kernel vs plain on captured inputs
    s10, _ = roll(batch(10, 64, dev), 30)
    args10, _ = capture_middle(s10)
    args_ovf, overflow = capture_middle(s10, max_colors=3)
    if overflow == 0:
        raise AssertionError("max_colors=3 did not overflow the coloring")
    s44, _ = roll(batch(44, 16, dev), 30)
    args44, _ = capture_middle(s44)
    max_err = max(compare_middle(args10, "64 x pyramid(10)"),
                  compare_middle(args_ovf, f"64 x pyramid(10), max_colors=3, "
                                           f"{overflow} overflow lanes/world"),
                  compare_middle(args44, "16 x pyramid(44)"))

    # ---- 3. the main path
    def healthy(states, ev):
        if int(ev.color_overflow.max()) != 0:
            raise AssertionError("color overflow on the main path")

    warm = batch(10, 512, dev)
    roll(warm, 2)                                    # first-use allocations
    states = batch(10, 512, dev)
    torch.cuda.synchronize()
    sm.solve_middle.launches = 0
    t0 = time.perf_counter()
    states, syncs = roll(states, 60, check=healthy)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = sm.solve_middle.launches
    b = states.bodies
    dyn = b.body_type == 2
    if launches <= 0:
        raise AssertionError("the main path never launched the solve-middle kernel")
    if not all(bool(torch.isfinite(t).all()) for t in (b.c, b.a, b.v, b.w)):
        raise AssertionError("NaN/inf in the body state")
    min_y = float(b.c[..., 1][dyn].min())
    if min_y <= 0.4:
        raise AssertionError(f"a box fell through: min center y {min_y}")
    ws10 = 512 * 60 / elapsed
    print(f"phase 3 main path 512 x pyramid(10) x 60 steps: {elapsed:.3f} s, "
          f"{ws10:.1f} worlds*steps/s, kernel launches={launches}, "
          f"host syncs/step={syncs / 60:.2f}, min box y={min_y:.4f}, "
          f"touching/world={float(states.contacts.touching.sum(1).float().mean()):.1f}")
    args_main, _ = capture_middle(states)

    # ---- 4. kernel path vs plain path, whole step
    ker, _ = roll(batch(10, 64, dev), 30)
    pln, _ = roll(batch(10, 64, dev), 30, middle=sm.solve_middle_plain)
    d = {k: (getattr(ker.bodies, k) - getattr(pln.bodies, k)).abs().max().item()
         for k in ("c", "a", "v")}
    awake_eq = bool(torch.equal(ker.bodies.awake, pln.bodies.awake))
    print(f"phase 4 kernel vs plain path, 64 x pyramid(10) x 30 steps: "
          f"max|dc|={d['c']:.3g} max|da|={d['a']:.3g} max|dv|={d['v']:.3g} "
          f"awake_equal={awake_eq}")
    if d["c"] > 2e-5 or d["a"] > 2e-5 or d["v"] > 1e-4 or not awake_eq:
        raise AssertionError(f"kernel path and plain path disagree: {d}")

    # ---- 5. large worlds
    big = batch(44, 128, dev)
    roll(batch(44, 8, dev), 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    big, syncs44 = roll(big, 20, check=healthy)
    torch.cuda.synchronize()
    el44 = time.perf_counter() - t0
    if not bool(torch.isfinite(big.bodies.c).all()):
        raise AssertionError("NaN/inf in the pyramid(44) body state")
    ws44 = 128 * 20 / el44
    print(f"phase 5 128 x pyramid(44) x 20 steps: {el44:.3f} s, {ws44:.1f} "
          f"worlds*steps/s, host syncs/step={syncs44 / 20:.2f}")

    # ---- 6. sleep
    states = batch(10, 64, dev)
    slept_at = None
    for i in range(300):
        states, ev = step_batched(states, DT, **MAIN)
        b = states.bodies
        if not bool((b.awake & (b.body_type == 2)).any()):
            slept_at = i + 1
            break
    if slept_at is None:
        raise AssertionError("the stack did not sleep within 300 steps")
    before = states.bodies.c.clone()
    states, ev = step_batched(states, DT, **MAIN)
    skipped = ev.host_syncs == 1 and bool(torch.equal(before, states.bodies.c))
    print(f"phase 6 sleep: every body asleep after {slept_at} steps; "
          f"all-asleep skip taken={skipped} (host syncs {ev.host_syncs})")
    if not skipped:
        raise AssertionError("the all-asleep skip was not taken")

    # ---- 7. kernel time per call
    times = {}
    for label, args in (("512 x pyramid(10)", args_main),
                        ("64 x pyramid(10)", args10),
                        ("16 x pyramid(44)", args44)):
        k_ms = time_call(sm.solve_middle, args)
        p_ms = time_call(sm.solve_middle_plain, args)
        times[label] = (k_ms, p_ms)
        print(f"phase 7 solve_middle [{label}]: kernel {k_ms:.4f} ms, "
              f"plain {p_ms:.4f} ms per call")

    k_ms, p_ms = times["512 x pyramid(10)"]
    print(f"card: {card}")
    print(json.dumps({"kernels": [{
        "name": "solve_middle", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": launches, "max_abs_err": max_err,
        "ms": k_ms, "plain_ms": p_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
