#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (box2d_mt_tpu_torch) on one GPU.

Run from the repository root: `python3 chip_smoke.py` runs every phase;
`python3 chip_smoke.py --phase N [N ...]` runs the build and the named
phases (and the phases whose inputs they time: 4 before 8, 10 before 12).
It needs a CUDA device and the CUDA toolkit (nvcc), builds the port's
kernels from `box2d_mt_tpu_torch/csrc/` (one nvcc per source, started
together), and runs these phases with continuous collision on
(continuous=True), raising on any failure. What the card tests in
tests/test_torch_kernels.py hold (each kernel against its plain version
at every launch shape) and what the benchmark measures (worlds*steps/s,
kernels a step, the step split by span) is not repeated here; a bound
counts bytes and operations as benchmark/roofline.py does, for K1 and K2
with its functions on the call's arguments.

  1. card and build: the `nvidia-smi` card line, each kernel's build time,
     registers and spills;
  4. the main path: 512 x pyramid(10) for 60 steps (velocity_iterations=8,
     position_iterations=3, max_colors=16, continuous=True), counting the
     kernels' launches; no NaN, no color or TOI overflow, every box above
     y = 0.4. The kernels' inputs are recorded through the `middle=`/`toi=`
     hooks, and afterwards K1 (last step) and K2 (the round with most
     touching lanes) are held against their plain versions on them (K1:
     atol 1e-5 on positions, 1e-4 on velocities and impulses, an equal
     convergence predicate; K2: every state and every t equal);
  5. the whole step through the kernels vs through the plain versions on
     the card, 64 x pyramid(10) for 20 steps, through the TOI impact
     (c, a to 2e-5, v to 1e-4, awake and toi_count equal);
  6. 128 x pyramid(44) (991 boxes) for 20 steps, counting both kernels'
     launches and holding K1 and K2 against their plain versions on the
     inputs recorded as in phase 4;
  7. sleep: 64 x pyramid(10) until every body sleeps (at most 300 steps),
     then one step that must take the all-asleep skip;
  8. each kernel's times per call on the main path's recorded inputs,
     read apart: on the device (20 launches captured in a CUDA graph and
     replayed between two events, inputs warm in the L2 cache as far as
     they fit; `torch.profiler`'s kernel durations beside it), the
     wrapper's time on the host (a host clock around 20 un-synchronized
     calls), and events around eager calls (the larger of the two); the
     same for an empty kernel, the launch floor; the plain version's time
     (events); and the bound (benchmark/roofline.py's count). K1 is also
     timed at 64 x pyramid(10) after 30 steps, 16 x pyramid(44) after 60
     and 4096 x pyramid(10) (the main path's inputs, each world eight
     times), each with its path (resident or ring), launch shape and the
     chain of passes its busiest world runs, and at 512 x pyramid(10)
     without sweeps and with each kind of sweep alone. K2 (its grid beside
     each) also on 4096 fast boxes thrown at a thin wall (131,072 lanes,
     4,096 active, one a warp), on 4096 x pyramid(10)'s first round with a
     touching lane (held to the plain version bit for bit), and on the
     main path's busiest round with only its costliest lane active (the
     chain floor: one lane's dependent chain and the launch);
 10. joint worlds, the sandwich's main path: 256 x tumbler(200) and
     512 x chain_links(30) for 120 and 180 steps (the chain's tip reaches
     the ground at step 134), counting K3-K6 launches (K3 and K6 once, K4
     8 times and K5 3 times per solved step); no NaN, the color overflow
     reported, every tumbler box inside the container (|x|, |y| < 10.5 in
     the turning container's frame), every chain plank above y = -0.2.
     The sandwich's inputs are recorded through the `sandwich=` hook, and
     afterwards each of K3-K6 is held against its plain version on the
     inputs of the step with the most solved lanes (every output and the
     packed table equal to atol 1e-5 positions, 1e-4 velocities and
     impulses);
 11. the whole step of a joint world through the kernels vs through the
     plain versions, 32 x tumbler(200) for 20 steps (c, a to 2e-5, v and
     the joint impulses to 1e-4, awake equal);
 12. K3-K6: the times of phase 8 on the tumbler's recorded inputs, each
     one's bound (the solved lanes' rows; K3's in the 32-byte sectors of
     the blob rows its gather touches, printed beside the count in 4-byte
     words) and, for K3 and K6, the device time of the PyTorch calls that
     compute the same function; K4 and K5 also on the chain's busiest
     step;
 13. continuous collision against Box2D's C++ goldens: bullet_test,
     continuous_test and bullet_on_stack as one batch of three worlds
     through K2 for 120 steps, each held over the steps its bound reads
     (0-8 below 2e-2, 0-119 below 3e-2, 0-59 below 0.1, the JAX
     package's bounds), with no color overflow and a TOI impact in each
     window; K2 against its plain version on the roll's busiest round;
 14. circles, chains and sensors: 512 x sphere_stack(10) x 120 steps (ten
     unit circles a world dropped at -50 m/s onto an edge ground: K1 with
     circle-circle lanes, K2 with circle proxies against the edge),
     counting the kernels' launches, with no NaN, no color or TOI
     overflow and every circle's center above y = 0.5; K1 held against
     its plain version on the step with the most e_circles lanes and K2 on
     the round with the most circle-proxy lanes, with the lane counts by
     manifold type and by proxy vertex count, and both timed there. 256 x
     pinball x 240 steps (a bullet circle in a chain loop with two
     motorized flippers: K3-K6, and K2 against the chain's edges) as in
     phase 10, K3-K6 held against their plain versions on its busiest
     step, with its solved lanes by manifold type. Then the zoo goldens on
     the card: twenty-six scenes (circle, chain, sensor and joint worlds,
     and phase 18's joint-free goldens; see ZOO_GOLDENS) as one padded
     batch, each held over the steps its JAX test reads at that test's
     bounds, the sensor's begin and end steps equal to the trace's, and
     falling_circle alone at the 6 and 2 iterations of its trace;
 15. mouse, friction, rope, motor, wheel, pulley and gear joints: 256 x
     car x 120 steps (Testbed Car.h: two wheel joints and 22 revolutes,
     circle wheels on edge terrain: K3-K6 and K2), counting the kernels'
     launches, with no NaN, every body above y = -3 and the chassis driven
     forward; K3-K6 held against their plain versions on its busiest step
     (phase 10's rules) and K2 on its busiest round (phase 4's). Then one
     batch of four copies of eight worlds (a box dragged by a mouse joint
     to (2.0, 0.5), and TYPE_BATCH: friction_top_down, apply_force,
     rope_swing, motor_drive, wheel_car, pulley_pair, gear_train) rolled
     240 steps through the kernels: each scene held to its C++ golden at
     the JAX package's bounds (JOINT_GOLDENS), the box within 0.1 m of its
     target by step 120; its first 20 steps again through the plain
     versions (phase 11's rules). Car's golden is held on world 0 of the
     car path, rolled on alone for steps 121-240. The rolls that check
     results and time nothing run in inference mode;
 16. large single worlds, above 1024 fixture slots (the grid pair finder)
     and, for many_bodies, above a block's shared memory (K1's and the
     sweeps' global planes): (a) the grid `find_pairs` runs against the
     all-pairs finder on 4 x many_bodies(1200) at steps 0, 30 and 60, to
     the bit, and with two slots a bucket (overflow > 0, unique pairs, a
     subset of all-pairs); (b) 16 x multithread_demo(2800) x 120 steps,
     (c) 32 x tiles(20, 200, 10) x 120 and (d) 4 x many_bodies(10000) x
     60 through K1 and K2, counting their launches from 0 before each
     roll: no NaN, no pair overflow, every box in its container, on the
     tiles or above the ground, K1's path; at (d) K1 and K2 against their
     plain versions (phase 4's rules) and the sandwich against K1 to the
     bit on K1's inputs; (e) the six ManyBodies variants as one batch, 12
     steps with `floater_drive`: no overflow, finite, inside the border;
     (f) the tiles(4, 20, 2) and multithread_demo(200) goldens as one
     batch for 240 steps, each under 0.05; (g) K1's device time and bound
     at (b)'s and (d)'s last step;
 17. the PreSolve hook and between-step mutations: (a) 256 x
     conveyor_belt x 120 and 256 x one_sided_platform x 120 with their
     batched hooks (a belt speed on the platform's contacts; the platform
     disabled while the actor is below its top) through K1 and K2,
     launches counted from 0 before each roll: no NaN, every box carried
     6 m along the belt, every actor on the platform at 11.005 +- 0.05;
     the conveyor rolled without the hook and with a hook that changes
     nothing, which must give the same states and host reads; K1 against
     its plain version on the step with the most solved lanes and K2 on
     the round with the most touching lanes; (b) the two hook goldens
     (conveyor_belt_240, one_sided_platform_240) as one batch under one
     hook, and the four mutation goldens (shape_editing, breakable with
     its split at step 167 on the TOI sub-step's PostSolve impulse,
     collision_processing, skier) as one batch driven by `mutate` between
     steps, at the JAX package's bounds (breakable's up to its break); (c)
     128 x pyramid(6) with a revolute and a distance joint added at run
     time by `mutate` (different bodies in each world), 60 steps through
     K3-K6, each held against its plain version on the busiest step
     (phase 10's rules); (d) shapecast.jsonl, rope_pbd_240 for a batch of
     1024 ropes (each step one replayed CUDA graph of its launches), and
     ray casts over 4096 worlds, each equal to the CPU result (1e-5; the
     rope's 60th step to 1e-4) and the shape cast and the rope within the
     JAX package's bounds of their C++ traces;
 18. the joint goldens no earlier phase held, each over all 240 steps of
     its trace at the JAX package's bounds (JOINT_GOLDENS):
     collision_filtering, dominos, pinball and tumbler(40) as one batch
     through K3-K6 and K2 at max_colors=32 (the tumbler's overflow color
     in use after step 59, none before), and theo_jansen as a batch of its
     own; both at 4 lanes a scene, with every kernel of the batch's path
     launched, counted from 0 before its rolls; add_pair(50, 7) on the
     card against the port's roll on the host's CPU through step 15 (c, a
     to 2e-5, v, w to 1e-4, awake and pairs equal). The joint-free goldens
     no earlier phase held are phase 14's. Phases 18 and 19 run side by
     side as the tasks of one pool of worker processes on the card
     (PARALLEL_WORKERS; the rolls are bound by the host), each task
     printing its own time;
 19. bit reproducibility (tools/consistency_torch.py): every scene of its
     list at 4 lanes, and 64 x pyramid(10), 64 x sphere_stack(10), 16 x
     car and 4 x many_bodies(1200), rolled twice for 120 steps as padded
     batches (consistency_torch.batch_groups): every State leaf equal
     between the two rolls and every lane equal to the first of its
     scene; the mutation sequence replayed twice. Phase 18's two golden
     batches are this check of their scenes: their first 120 steps rolled
     again. Any difference fails the run;
 20. the sharded step (box2d_mt_tpu_torch/parallel/sharding.py): 512 x
     pyramid(10) x 60 and 256 x car x 60 sharded over [cuda:0, cuda:0],
     two host threads with a CUDA stream each on the one card, and over
     every card where more are visible, each world held bit for bit to
     the unsharded roll (every State leaf and the last step's Events);
     K1, K2 and K3-K6 launched from both threads, counted from 0 before
     the two-shard rolls. For the pyramid: worlds*steps/s unsharded, with
     1 shard and with 2 shards on the one card, the host syncs a step;
 21. the coloring kernel K7 (csrc/coloring.cu) on the main path of the
     benchmark's scale: 512 x pyramid(20) (K = 1024 slots, N = 256
     bodies) for 60 steps inside `trace.collect()`, every coloring of
     the roll recorded; K7 held bit for bit to `_luby` on the call with
     the most active slots, at max_colors 16 and 3 (overflow); its
     launches, counted from 0 before each roll, against the event
     "coloring.kernel" and the colorings ("coloring.runs"), and the host
     reads a step, and the same for 256 x tumbler(200) x 30 (joints and
     contacts); K7's times per call as in phase 8, `_luby`'s (events
     around eager calls) and the bound: the bytes of the call (int64
     endpoints, three flag bytes and the int32 color and rank a slot, the
     overflow) over the HBM rate;
 22. the TOI sub-step kernel K8 (csrc/toi.cu `toi_substep_kernel`) at
     the benchmark's scale: 16 x multithread_demo(2800) for 40 steps
     (2048 lanes a world; the landing's sub-steps) and 512 x pyramid(20)
     for 60 (128 lanes a world), every sub-step's arguments recorded; K8
     held bit for bit to `toi_substep_passes_plain` on the sub-step with
     the most solved lanes of each; its launches, counted from 0 before
     each roll, against the event "toi.substep_kernel"; its times per call
     as in phase 8, the plain version's (events around eager calls) and
     the bound: the bytes K8 must move for the call over the HBM rate.

Launches are counted at `cuda_build.call`, by the C entry each launch
goes through. The last lines are the card line, the kernels' JSON record
(for each kernel its launches on each path the run rolled, counted from 0
before the path, and summed; the largest difference from its plain
version; its times and bound where the run timed it) and
{"ok": true, "device": {...}}. Nothing is printed as a result, and the
exit code is not 0, when there is no CUDA device.
"""

import concurrent.futures
import contextlib
import dataclasses
import functools
import json
import pathlib
import subprocess
import sys
import threading
import time

DT = 1.0 / 60.0
MAIN = dict(velocity_iterations=8, position_iterations=3, max_colors=16,
            continuous=True)
ROOT = pathlib.Path(__file__).resolve().parent
KERNELS = {
    "solve_middle": dict(route="cuda", source="box2d_mt_tpu_torch/csrc/solve_middle.cu",
                         replaces="box2d_mt_tpu/ops/pallas_solve.py:273"),
    "toi": dict(route="cuda", source="box2d_mt_tpu_torch/csrc/toi.cu",
                replaces="box2d_mt_tpu/ops/pallas_toi.py:48"),
    "pack_packed": dict(route="cuda", source="box2d_mt_tpu_torch/csrc/solve_middle.cu",
                        replaces="box2d_mt_tpu/ops/pallas_solve.py:363"),
    "vel_iter_packed": dict(route="cuda", source="box2d_mt_tpu_torch/csrc/solve_middle.cu",
                            replaces="box2d_mt_tpu/ops/pallas_solve.py:396"),
    "pos_iter_packed": dict(route="cuda", source="box2d_mt_tpu_torch/csrc/solve_middle.cu",
                            replaces="box2d_mt_tpu/ops/pallas_solve.py:429"),
    "unpack_packed": dict(route="cuda", source="box2d_mt_tpu_torch/csrc/solve_middle.cu",
                          replaces="box2d_mt_tpu/ops/pallas_solve.py:462"),
    "color_walk": dict(route="cuda", source="box2d_mt_tpu_torch/csrc/coloring.cu",
                       replaces=None),
    "toi_substep": dict(route="cuda", source="box2d_mt_tpu_torch/csrc/toi.cu",
                        replaces=None),
}
SOURCES = ("solve_middle", "toi", "coloring")    # csrc/<name>.cu, one nvcc each
SANDWICH_NAMES = ("pack_packed", "vel_iter_packed", "pos_iter_packed", "unpack_packed")
L2_BYTES = 50e6               # one NVIDIA H100 SXM's L2 cache
# f32 operations of K2 per trip of each of its four loops, counted from the
# kernel's source (sinf and cosf as 20 operations each; K1's and the
# sweeps' are benchmark/roofline.py's K1_OPS_VEL and K1_OPS_POS)
K2_OPS = dict(outer=180, gjk=140, push=240, root=140)
# rows of the packed table (52 a lane) that one sweep of a solved lane
# reads and writes: velocity rows 0-31 and the impulses 47-50, which it
# writes back; position rows 0-3, 6-9 and 32-46, and it writes min_sep
K4_ROWS, K5_ROWS = (36, 4), (23, 1)
# the CCD scenes held to their C++ goldens (tests/golden/<name>_120.jsonl):
# bodies in the trace, steps the bound reads, the JAX package's bound
# (tests/test_golden_zoo.py:117-139); frozen with one set of capacities so
# that the three share a batch
CCD_GOLDENS = {"bullet_test": (3, 9, 2e-2), "continuous_test": (2, 120, 3e-2),
               "bullet_on_stack": (7, 60, 0.1)}
CCD_CAPACITY = dict(body_capacity=8, fixture_capacity=8, contact_capacity=64)
# the packed constraint table's manifold-type row (ops/solver.py
# pack_cc_blob_t) and the type names, in MANIFOLD_* order
MTYPE_ROW = 46
MTYPES = ("e_circles", "e_faceA", "e_faceB")
# the zoo scenes held to their C++ goldens on the card (phase 14):
# (builder, its arguments, golden file, bodies in the trace, steps the
# bounds read, bound on the worst error, bound on the last step's error
# or None) at the JAX package's bounds (tests/test_step.py,
# tests/test_golden_zoo.py, tests/test_golden_interactive.py); all roll as
# one batch, frozen with the capacities of the largest
ZOO_GOLDENS = {
    "distance_pendulum": ("distance_pendulum", (), "distance_240", 2, 240, 5e-3, None),
    "sphere_stack(5)": ("sphere_stack", (5,), "sphere_stack_240", 6, 240, 0.8, 0.08),
    "bridge(12)": ("bridge", (12,), "bridge_240", 18, 240, 0.25, 0.10),
    "heavy_on_light": ("heavy_on_light", (), "heavy_on_light_240", 3, 240, 0.08, 0.02),
    "varying_restitution": ("varying_restitution", (), "varying_restitution_300", 8, 300,
                            1e-2, None),
    "edge_test": ("edge_test", (), "edge_test_120", 3, 120, 5e-3, 1e-4),
    "chain_problem": ("chain_problem", (), "chain_problem_180", 2, 180, 5e-3, 1e-4),
    "web": ("web", (), "web_240", 5, 240, 1e-4, None),
    "slider_crank": ("slider_crank", (), "slider_crank_240", 4, 240, 2e-2, 5e-3),
    "basic_slider_crank": ("basic_slider_crank", (), "basic_slider_crank_240", 4, 240,
                           1e-2, 2e-3),
    "body_types": ("body_types", (), "body_types_240", 4, 240, 2e-2, None),
    "mobile(3)": ("mobile", (3,), "mobile_240", 16, 240, 0.8, 0.4),
    "mobile_balanced(3)": ("mobile_balanced", (3,), "mobile_balanced_240", 16, 240, 1e-2,
                           None),
    "varying_friction": ("varying_friction", (), "varying_friction_300", 11, 300, 0.05,
                         None),
    "vertical_stack(5)": ("vertical_stack", (5,), "stack_5_240", 6, 240, 0.02, 0.02),
    "cantilever(4)": ("cantilever", (4,), "cantilever_240", 12, 240, 0.12, 0.05),
    "chain_links(10)": ("chain_links", (10,), "chain_links_240", 11, 240, 0.05, None),
    # only the pyramids' 42 boxes (slots 1-42) are held; they must sleep
    "sleep_collide_perf(2, 6, 1, 20)": ("sleep_collide_perf", (2, 6, 1, 20),
                                        "sleep_collide_perf_300", 64, 300, 0.05, None),
    # begin and end steps equal the trace's; the ball's final height
    "sensor_drop": ("sensor_drop", (), "sensor_180", None, 180, 5e-3, None),
    # the joint-free goldens of phase 18 (tests/test_golden_zoo.py:143-189,
    # :222-227, :262-268, tests/test_step.py:72-76)
    "character_collision": ("character_collision", (), "character_collision_240", 11, 240,
                            0.1, None),
    "compound_shapes(4)": ("compound_shapes", (4,), "compound_shapes_240", 13, 60, 0.2, None),
    "confined(4, 3)": ("confined", (4, 3), "confined_240", 13, 240, 0.01, None),
    "heavy_on_light_two": ("heavy_on_light_two", (), "heavy_on_light_two_240", 4, 240, 0.15,
                           0.08),
    "poly_shapes(8)": ("poly_shapes", (8,), "poly_shapes_240", 9, 240, 1.5, None),
    "pyramid(5)": ("pyramid", (5,), "pyramid_5_240", 16, 240, 0.05, 0.02),
    "edge_shapes(8)": ("edge_shapes", (8,), "edge_shapes_240", 9, 120, 0.1, None),
}
# a bound on the first steps of a zoo golden's window: (steps, bound)
ZOO_EARLY = {"poly_shapes(8)": (60, 0.3)}
ZOO_CAPACITY = dict(body_capacity=64, fixture_capacity=128, contact_capacity=512,
                    joint_capacity={"revolute": 15, "distance": 8, "prismatic": 1,
                                    "weld": 11})
# the goldens of the joint scenes held on the card (phases 15 and 18):
# (golden file, bodies in the trace, bound on the worst error over the 240
# steps or None, (steps, bound) on the first steps or None, bound on the
# last step or None) at the JAX package's bounds (tests/test_step.py:138-177,
# tests/test_golden_zoo.py:159-163, :193-215, :228-235, :247-253). No
# color overflow is allowed in the steps a bound reads
JOINT_GOLDENS = {
    "friction_top_down": ("friction_240", 2, 5e-3, None, None),
    "apply_force": ("apply_force_240", 12, 1e-4, None, None),
    "rope_swing": ("rope_240", 2, 2e-2, None, None),
    "motor_drive": ("motor_240", 2, 5e-3, None, None),
    "wheel_car": ("wheel_240", 3, 5e-2, None, None),
    "car": ("car_240", 30, 0.15, None, None),
    "gear_train": ("gear_240", 4, 0.03, (130, 1e-4), 1e-4),
    "pulley_pair": ("pulley_240", 3, 1e-2, None, None),
    "collision_filtering": ("collision_filtering_240", 8, 0.2, None, 0.05),
    "dominos": ("dominos_240", 23, 0.4, None, None),
    "pinball": ("pinball_240", 4, 0.05, None, None),
    "tumbler": ("tumbler_240", 42, None, (60, 0.05), None),
}
# phase 15's batch of the joint types, after the mouse world: every golden
# scene but car, whose golden is world 0 of the car path. One batch costs
# less than one for each set of joint types: a step's fixed passes weigh
# more than the padded types'
TYPE_BATCH = ("friction_top_down", "apply_force", "rope_swing", "motor_drive", "wheel_car",
              "pulley_pair", "gear_train")
# car's body slots: ground, teeter, 20 bridge planks, 5 boxes, chassis, wheels
CAR_CHASSIS = 27
# what the run found, for the kernels' record at its end: each kernel's
# largest difference from its plain version (`keep_worst`), the launches of
# each path the run rolled, counted from 0 before it (`read_launches`),
# and each kernel's times where the run timed it
WORST, PATHS, TIMES = {}, {}, {}
# the recorded inputs that a later phase times: phase 4's ("main": K1's
# and K2's) and phase 10's ("sandwich": K3-K6's at the tumbler and the chain)
INPUTS = {}


def keep_worst(name, err):
    WORST[name] = max(WORST.get(name, 0.0), err)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def batch(rows, n, device):
    from box2d_mt_tpu_torch.models import scenes
    from box2d_mt_tpu_torch.state import replicate
    return replicate(scenes.pyramid(rows, device=device), n)


def joint_batch(scene, size, n, device):
    """n copies of scenes.<scene>(size), or of scenes.<scene>() when size
    is None."""
    from box2d_mt_tpu_torch.models import scenes
    from box2d_mt_tpu_torch.state import replicate
    args = () if size is None else (size,)
    return replicate(getattr(scenes, scene)(*args, device=device), n)


def roll(states, n_steps, check=None, **kw):
    """n_steps of the main-path step; `check(states, events)` after each."""
    from box2d_mt_tpu_torch.world import step_batched
    syncs = 0
    for _ in range(n_steps):
        states, ev = step_batched(states, DT, **dict(MAIN, **kw))
        syncs += ev.host_syncs
        if check is not None:
            check(states, ev)
    return states, syncs


def checked_step(*args, **kw):
    """step_batched in inference mode, for the rolls that check results
    and time nothing: the same values, with autograd's dispatch skipped
    on the host."""
    import torch
    from box2d_mt_tpu_torch.world import step_batched
    with torch.inference_mode():
        return step_batched(*args, **kw)


def capture_middle(states):
    """One more step, recording the solve middle's arguments."""
    rec = Recorder()
    roll(states, 1, middle=rec.solve_middle)
    return rec.middle


def capture_toi(states, n_steps):
    """Roll up to n_steps; return the lanes of the first time-of-impact
    call in which some lane reports touching."""
    from box2d_mt_tpu_torch.ops import toi as ktoi
    from box2d_mt_tpu_torch.world import step_batched
    got = []

    def hook(*args):
        out = ktoi.time_of_impact_lanes(*args)
        if not got and bool((out[0] == 3).any()):
            got.append(tuple(a.clone() for a in args))
        return out

    for _ in range(n_steps):
        states, _ = step_batched(states, DT, toi=hook, **MAIN)
        if got:
            return got[0]
    raise AssertionError(f"no lane reported touching within {n_steps} steps")


class Recorder:
    """`middle=` and `toi=` hooks for step_batched that launch the kernels
    and keep their arguments (references only: no copy and no host read
    in the step), so that a run can be held against the plain versions
    afterwards."""

    def __init__(self):
        self.middle = None
        self.toi = []

    def solve_middle(self, *args):
        from box2d_mt_tpu_torch.ops.solve_middle import solve_middle
        self.middle = args
        return solve_middle(*args)

    def time_of_impact(self, *args):
        from box2d_mt_tpu_torch.ops import toi as ktoi
        out = ktoi.time_of_impact_lanes(*args)
        self.toi.append((args, out[0]))
        return out

    def busiest_toi(self):
        """The recorded lanes of the call with the most touching lanes,
        then the most active ones."""
        if not self.toi:
            raise AssertionError("no time-of-impact call was recorded")
        return max(self.toi, key=lambda r: (int((r[1] == 3).sum()),
                                            int(r[0][-1].sum())))[0]


def compare_middle(args, label, phase):
    """K1 vs its plain version on the same inputs."""
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
    print(f"phase {phase} K1 [{label}] lanes solved={lanes} max|diff| pos={err['pos']:.3g} "
          f"vel={err['vel']:.3g} impulse={err['impulse']:.3g} "
          f"predicate_equal={bool(torch.equal(ok_k, ok_p))}")
    if lanes == 0:
        raise AssertionError(f"{label}: no contact lanes to solve")
    if err["pos"] > 1e-5 or err["vel"] > 1e-4 or err["impulse"] > 1e-4:
        raise AssertionError(f"{label}: kernel disagrees with the plain version: {err}")
    if not torch.equal(ok_k, ok_p):
        raise AssertionError(f"{label}: convergence predicate differs")
    keep_worst("solve_middle", max(err.values()))


def compare_toi(args, label, phase, min_touching=1):
    """K2 vs its plain version on the same lanes. Both run the same
    arithmetic in the same order (the kernel is built with --fmad=false),
    so every state and every t must be equal."""
    import torch
    from box2d_mt_tpu_torch.ops import toi as ktoi
    ks, kt = ktoi.time_of_impact_lanes(*args)
    ps, pt = ktoi.time_of_impact_lanes_plain(*args)
    torch.cuda.synchronize()
    n = ks.shape[0]
    active = int(args[-1].sum())
    bad = int((ks != ps).sum())
    touching = int((ks == 3).sum())
    max_dt = float((kt - pt).abs().max()) if n else 0.0
    print(f"phase {phase} K2 [{label}] lanes={n} active={active} touching={touching} "
          f"state mismatches={bad} max|dt|={max_dt:.3g}")
    if bad != 0 or not torch.equal(kt, pt):
        raise AssertionError(f"{label}: the TOI kernel disagrees with the plain version")
    if touching < min_touching:
        raise AssertionError(f"{label}: {touching} touching lanes, expected >= {min_touching}")
    keep_worst("toi", max_dt)


def fast_box_worlds(n, device, seed=0):
    """n one-box worlds: a 0.2 m box at 60-240 m/s, aimed within 0.3 rad
    of a thin static box 2 m away, at a random angle and spin."""
    import numpy as np
    import torch
    from box2d_mt_tpu_torch import settings, shapes
    from box2d_mt_tpu_torch.state import replicate
    from box2d_mt_tpu_torch.world import WorldBuilder
    wb = WorldBuilder(gravity=(0.0, 0.0))
    wall = wb.create_body(position=(2.0, 0.0))
    wb.create_fixture(wall, shapes.Polygon.box(0.05, 3.0))
    box = wb.create_body(body_type=settings.DYNAMIC_BODY, position=(0.0, 0.0))
    wb.create_fixture(box, shapes.Polygon.box(0.1, 0.1), density=1.0)
    states = replicate(wb.freeze(device=device), n)
    rng = np.random.default_rng(seed)
    speed = rng.uniform(60.0, 240.0, n)
    heading = rng.uniform(-0.3, 0.3, n)
    vel = np.stack([speed * np.cos(heading), speed * np.sin(heading)], -1)
    b = states.bodies
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    a = b.a.clone()
    a[:, box] = t(rng.uniform(0.0, np.pi / 2, n))
    v = b.v.clone()
    v[:, box] = t(vel)
    w = b.w.clone()
    w[:, box] = t(rng.uniform(-20.0, 20.0, n))
    return dataclasses.replace(states, bodies=dataclasses.replace(b, a=a, a0=a.clone(), v=v, w=w))


def time_call(fn, args, reps=20):
    """ms per call between two CUDA events around `reps` eager calls: the
    device's time or the host's launch rate, whichever is larger."""
    import torch
    for _ in range(2):
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


def device_time(fn, args, reps=20, replays=5):
    """ms per call on the device alone: `reps` calls captured once in a
    CUDA graph (a replay runs no Python and no wrapper) and replayed
    between two events. The same inputs every time, so they stay in the
    L2 cache as far as they fit."""
    import torch
    for _ in range(2):
        fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn(*args)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (reps * replays)


def host_time(fn, args, reps=20):
    """ms of host time per un-synchronized call: what a launch-bound step
    pays for the call, whatever the kernel takes."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * elapsed / reps


def profiler_time(fn, args, reps=20):
    """ms per call summed over the kernels' own durations as
    `torch.profiler` traces them, or None when it traces no device
    activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn(*args)
        torch.cuda.synchronize()
    spans = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    return 1e-3 * sum(spans) / reps if spans else None


def measure(fn, args, profiler=True):
    """One kernel's times per call through its wrapper: `ms` on the device
    with the launches back to back (graph replay), `profiler_ms` (the
    kernels' own durations in eager calls, which the host launches with
    gaps between them), `host_ms` (the wrapper on the host) and
    `wrapper_ms` (events around eager calls: the larger of the device's
    time and the host's launch rate)."""
    return dict(wrapper_ms=time_call(fn, args), ms=device_time(fn, args),
                host_ms=host_time(fn, args),
                profiler_ms=profiler_time(fn, args) if profiler else None)


def show(m, n_bytes=0):
    """`n_bytes`: what one call touches; the repeats find it in the L2
    cache when it fits, whatever the step's caller would find."""
    prof = m["profiler_ms"]
    warm = ("repeats warm" if n_bytes <= L2_BYTES else "repeats partly cold") + \
        f": {n_bytes / 1e6:.1f} MB touched, {L2_BYTES / 1e6:.0f} MB L2"
    return (f"device {m['ms']:.4f} ms (graph replay, back to back; {warm}), "
            f"kernel alone in eager calls (profiler) "
            f"{'not measured' if prof is None else f'{prof:.4f} ms'}, wrapper on the host "
            f"{m['host_ms']:.4f} ms, events around eager calls {m['wrapper_ms']:.4f} ms")


@functools.cache
def launch_floor():
    """The times of an empty kernel (one warp, no argument read), launched
    as the port's kernels are: what any launch costs on this card (measured
    once a process)."""
    import ctypes
    import torch
    from box2d_mt_tpu_torch import cuda_build
    fn = cuda_build.load("solve_middle").empty_launch
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int

    def launch():
        if fn(torch.cuda.current_stream().cuda_stream) != 0:
            raise RuntimeError("the empty kernel did not launch")

    return measure(launch, ())


def least_ms(n_bytes, ops=0):
    """The least time (ms) the card could take by benchmark/roofline.py's
    peaks, and what bounds it ("bytes" or "operations")."""
    from benchmark import roofline
    by_ops = ops / roofline.F32_FLOP_PER_S > n_bytes / roofline.HBM_BYTES_PER_S
    return 1e3 * roofline.bound_seconds(n_bytes, ops), "operations" if by_ops else "bytes"


def arg_infos(args):
    """A kernel call's arguments as benchmark/roofline.py counts them: an
    ArgInfo each, built as the benchmark's recorder builds them."""
    from benchmark.tracing import CallRecorder
    return [CallRecorder._info(a) for a in args]


def k1_bound(args):
    """K1's bytes for this call and its least time (`least_ms`), counted by
    benchmark/roofline.py as the benchmark's k1_roofline counts them."""
    from benchmark import roofline
    info = arg_infos(args)
    n_bytes = roofline.k1_bytes(info)
    return n_bytes, least_ms(n_bytes, roofline.k1_ops(info))


def costliest_lane(lanes):
    """The lanes with only the active lane of most f32 operations (loop
    trips of the plain version, weighted as in K2_OPS) left active."""
    import torch
    from box2d_mt_tpu_torch.ops import toi as ktoi
    stats = {}
    ktoi.time_of_impact_lanes_plain(*lanes, stats=stats)
    ops = sum(K2_OPS[k] * v.to(torch.int64) for k, v in stats.items())
    only = torch.zeros_like(lanes[-1])
    only[int(ops.argmax())] = True
    return (*lanes[:-1], only)


def time_toi(lanes, label, phase):
    """K2's times on one set of lanes (see `measure`), the plain version's,
    the loop trips and the bound; prints one line and returns them."""
    from benchmark import roofline
    from box2d_mt_tpu_torch.ops import toi as ktoi
    m = measure(ktoi.time_of_impact_lanes, lanes)
    floor = launch_floor()
    plain = time_call(ktoi.time_of_impact_lanes_plain, lanes, reps=3)
    stats = {}
    state, _ = ktoi.time_of_impact_lanes_plain(*lanes, stats=stats)
    trips = {k: int(v.sum()) for k, v in stats.items()}
    most = {k: int(v.max()) for k, v in stats.items()}
    n_bytes = roofline.k2_bytes(arg_infos(lanes))
    bnd = least_ms(n_bytes, sum(K2_OPS[k] * n for k, n in trips.items()))
    active = int(lanes[-1].sum())
    print(f"phase {phase} toi [{label}, {lanes[-1].shape[0]} lanes, {active} active, "
          f"{int((state == 3).sum())} touching]: {show(m, n_bytes)}; "
          f"{m['ms'] / floor['ms']:.2f} x the launch floor; plain {plain:.4f} ms per call; "
          f"bound {bnd[0]:.6f} ms ({bnd[1]}: {n_bytes} B; device time at "
          f"{100 * bnd[0] / m['ms']:.2f}% of it); loop trips {trips}, most in a lane {most}")
    return dict(m, plain_ms=plain, bound=bnd, n_bytes=n_bytes, lanes=lanes[-1].shape[0],
                active=active)


class SandwichRecorder:
    """A `sandwich=` hook for step_batched that launches K3-K6 and keeps,
    per step, references to the inputs that no later call changes (blob,
    layout, each sweep's body planes) and the solved-lane count as a
    device scalar: no copy and no host read in the step. The packed
    table, which the sweeps update in place, is rebuilt afterwards by
    replaying the step's launches (`replay`)."""

    def __init__(self):
        self.steps = []

    def hook(self):
        from box2d_mt_tpu_torch.ops import solve_middle as sm

        def pack(blob, perm, color_start):
            self.steps.append(dict(blob=blob, perm=perm, color_start=color_start,
                                   lanes=color_start[:, -1].sum(), vel=[], pos=[]))
            return sm.pack_packed(blob, perm, color_start)

        def vel_iter(packed, perm, color_start, dyn_ab, vel):
            self.steps[-1]["dyn_ab"] = dyn_ab
            self.steps[-1]["vel"].append(vel)
            return sm.vel_iter_packed(packed, perm, color_start, dyn_ab, vel)

        def pos_iter(packed, perm, color_start, dyn_ab, pos):
            self.steps[-1]["pos"].append(pos)
            return sm.pos_iter_packed(packed, perm, color_start, dyn_ab, pos)

        return sm.Sandwich(pack, vel_iter, pos_iter, sm.unpack_packed)

    def busiest(self):
        """The recorded step with the most solved lanes."""
        import torch
        if not self.steps:
            raise AssertionError("the sandwich was not recorded")
        lanes = torch.stack([s["lanes"] for s in self.steps]).tolist()
        return self.steps[max(range(len(lanes)), key=lanes.__getitem__)]


def compare_sandwich(step, label, phase):
    """Each of K3-K6 against its plain version on one recorded step.
    Both start every comparison from the same packed table: the plain
    pack's (unused positions 0), then advanced by replaying the step's
    kernel launches. Returns the inputs of each kernel's first call (for
    timing)."""
    import torch
    from box2d_mt_tpu_torch.ops import solve_middle as sm
    blob, perm, cs, dyn = step["blob"], step["perm"], step["color_start"], step["dyn_ab"]
    lanes = int(cs[:, -1].sum())
    if lanes == 0:
        raise AssertionError(f"{label}: no contact lanes to solve")
    used = (torch.arange(perm.shape[1], device=perm.device) < cs[:, -1:])[:, None, :]
    err, first = {}, {}

    def diff(a, b):
        return (a - b).abs().max().item()

    table = sm.pack_packed_plain(blob, perm, cs)
    first["pack_packed"] = (blob, perm, cs)
    err["pack_packed"] = diff(torch.where(used, sm.pack_packed(blob, perm, cs), 0.0), table)
    errs = []
    for i, vel in enumerate(step["vel"]):
        if i == 0:
            first["vel_iter_packed"] = (table.clone(), perm, cs, dyn, vel)
        plain_table = table.clone()
        p_out = sm.vel_iter_packed_plain(plain_table, perm, cs, dyn, vel)
        k_out = sm.vel_iter_packed(table, perm, cs, dyn, vel)
        errs.append(max(diff(k_out, p_out), diff(table, plain_table)))
    err["vel_iter_packed"] = max(errs)
    errs, pos_errs = [], []
    for i, pos in enumerate(step["pos"]):
        if i == 0:
            first["pos_iter_packed"] = (table.clone(), perm, cs, dyn, pos)
        plain_table = table.clone()
        p_out = sm.pos_iter_packed_plain(plain_table, perm, cs, dyn, pos)
        k_out = sm.pos_iter_packed(table, perm, cs, dyn, pos)
        pos_errs.append(diff(k_out, p_out))
        errs.append(diff(table, plain_table))
    err["pos_iter_packed"] = max(errs + pos_errs)
    first["unpack_packed"] = (table, perm, cs)
    err["unpack_packed"] = diff(sm.unpack_packed(table, perm, cs),
                                sm.unpack_packed_plain(table, perm, cs))
    torch.cuda.synchronize()
    print(f"phase {phase} K3-K6 [{label}] lanes solved={lanes} max|diff| "
          + " ".join(f"{k}={v:.3g}" for k, v in err.items()))
    if max(pos_errs) > 1e-5 or max(err.values()) > 1e-4:
        raise AssertionError(f"{label}: a sandwich kernel disagrees with its "
                             f"plain version: {err}")
    for name, e in err.items():
        keep_worst(name, e)
    return first


def sweep_path(args):
    """Which way K4 takes these inputs: its launch shape, whether a world's
    lanes outgrow the shared-memory buffers (the ring turns), and how
    many chunks the overflow color has (a line of text)."""
    from box2d_mt_tpu_torch.ops import solve_middle as sm
    blob, perm, cs, _, vel = args[:5]
    shape = sm.sweep_shape(vel.shape[-1], perm.shape[-1], cs.shape[-1] - 1)
    tiles = -(-int(cs[:, -1].max()) // shape.tile)
    overflow = int((cs[:, -1] - cs[:, -2]).max())
    staging = (f"the ring turns ({tiles} tiles a world through {shape.n_buffers} buffers)"
               if tiles > shape.n_buffers else f"whole worlds staged at entry ({tiles} tiles)")
    return (f"{shape.threads_per_world} threads a world, {shape.worlds_per_block} worlds "
            f"a block, tile {shape.tile}, {staging}, overflow color {overflow} lanes "
            f"in {-(-overflow // sm.CK)} chunks, K6 (worlds a block, blocks a world) "
            f"{sm.unpack_shape(*perm.shape)}")


def middle_path(args):
    """Which way K1 takes these inputs: its path and launch shape, and the
    chain of passes its busiest world runs: a sweep passes through each
    non-empty color (each chunk of the overflow color), once more for
    each tile border that splits one on the ring path (a line of text)."""
    from box2d_mt_tpu_torch.ops import solve_middle as sm
    blob, perm, cs, _, vel, _, _, _, vi, pi = args
    shape = sm.middle_shape(vel.shape[-1], perm.shape[-1], cs.shape[-1] - 1)
    row = cs[int(cs[:, -1].argmax())].tolist()
    total, mc = row[-1], len(row) - 1
    tile = perm.shape[-1] if shape.resident else shape.tile
    spans = [(row[c], row[c + 1]) for c in range(mc - 1)]
    spans += [(ch, min(ch + sm.CK, row[mc])) for ch in range(row[mc - 1], row[mc], sm.CK)]
    passes = sum(max(a, t0) < min(b, t0 + tile) for t0 in range(0, total, tile)
                 for a, b in spans)
    colors = sum(a < b for a, b in spans[:mc - 1]) + (row[mc] > row[mc - 1])
    return (f"{'resident' if shape.resident else 'ring'} path, "
            f"a block of {shape.threads_per_world} threads a world"
            f"{'' if shape.resident else f', tiles of {tile} lanes'}; busiest world: "
            f"{total} lanes in {colors} non-empty colors, {passes} passes a sweep x "
            f"{vi + pi} sweeps = {passes * (vi + pi)} passes")


def sandwich_vs_k1(args, label, phase):
    """K3 -> vi x K4 -> integrate_positions -> pi x K5 -> K6 against K1 on
    the inputs of a joint-free batch, to the bit: both run one sweep
    implementation and apply an overflow chunk in lane order."""
    import torch
    from box2d_mt_tpu_torch.ops import solve_middle as sm
    from box2d_mt_tpu_torch.ops.integrate import integrate_positions
    blob, perm, cs, dyn, vel, pos, movable, dt, vi, pi = args
    k_vel, k_pos, k_aux = sm.solve_middle(*args)
    table = sm.pack_packed(blob, perm, cs)
    for _ in range(vi):
        vel = sm.vel_iter_packed(table, perm, cs, dyn, vel)
    c, a, v, w = integrate_positions(pos[:, 0:2].transpose(1, 2), pos[:, 2],
                                     vel[:, 0:2].transpose(1, 2), vel[:, 2], dt, movable)
    vel = torch.stack([v[..., 0], v[..., 1], w], 1).contiguous()
    pos = torch.stack([c[..., 0], c[..., 1], a], 1).contiguous()
    for _ in range(pi):
        pos = sm.pos_iter_packed(table, perm, cs, dyn, pos)
    aux = sm.unpack_packed(table, perm, cs)
    torch.cuda.synchronize()
    err = {"pos": (pos - k_pos).abs().max().item(), "vel": (vel - k_vel).abs().max().item(),
           "aux": (aux - k_aux).abs().max().item()}
    print(f"phase {phase} sandwich vs K1 [{label}] max|diff| pos={err['pos']:.3g} "
          f"vel={err['vel']:.3g} impulse/min_sep={err['aux']:.3g}; K1: {middle_path(args)}; "
          f"K4: {sweep_path(args)}")
    if max(err.values()) != 0.0:
        raise AssertionError(f"{label}: the sandwich must equal K1 to the bit: {err}")
    for name in SANDWICH_NAMES:
        keep_worst(name, 0.0)


def sandwich_bytes(first):
    """Bytes each of K3-K6 must move for these inputs, each read or
    written once: the solved lanes' rows of the packed table that the
    function touches, their perm and dyn_ab entries, color_start, and the
    body planes in and out; K6 writes the whole (W, 5, C) aux. K3 gathers
    a solved lane's 51 words from slot-order blob rows, and DRAM and L2
    move whole 32-byte sectors: its count is the distinct sectors of each
    world's blob rows that the gather through perm touches, the packed
    rows it writes and perm. Returns the counts, the solved lanes and K3's
    count in 4-byte words alone (the count before sectors)."""
    import torch
    blob, perm, cs = first["pack_packed"]
    nw, rows, nc = blob.shape
    solved = int(cs[:, -1].sum())
    cs_b = cs.numel() * cs.element_size()
    planes = 2 * first["vel_iter_packed"][4].numel() * 4
    sweep = lambda rw: solved * (4 * sum(rw) + 4 + 1) + cs_b + planes
    used = torch.arange(nc, device=perm.device) < cs[:, -1:]
    row0 = (torch.arange(nw, device=perm.device)[:, None] * rows
            + torch.arange(rows, device=perm.device)[None, :]) * nc      # (W, rows)
    words = row0[:, :, None] + perm.long()[:, None, :]                  # (W, rows, C)
    sectors = torch.unique(words[used[:, None, :].expand(-1, rows, -1)] * 4 // 32).numel()
    written = solved * 4 * (rows + 1) + solved * 4 + cs_b
    return {"pack_packed": 32 * sectors + written,
            "vel_iter_packed": sweep(K4_ROWS), "pos_iter_packed": sweep(K5_ROWS),
            "unpack_packed": solved * (4 * 5 + 4) + cs_b + nw * 5 * nc * 4}, solved, \
        solved * 4 * rows + written


def library_calls(first):
    """The one PyTorch call that computes (a superset of) K3 and of K6 on
    the same inputs, for timing only: a gather of the blob rows through
    perm, and a scatter of the five result rows into zeros. The sweeps
    have no such call."""
    import torch
    blob, perm, _ = first["pack_packed"]
    idx = perm.long()[:, None, :]
    table = first["unpack_packed"][0]
    rows = table[:, [47, 48, 49, 50, 51]].contiguous()
    idx5 = idx.expand(-1, 5, -1)
    return {"pack_packed": (torch.gather, (blob, 2, idx.expand(-1, blob.shape[1], -1))),
            "unpack_packed": (lambda: torch.zeros_like(rows).scatter_(2, idx5, rows), ())}


def run_joint_scene(scene, size, n_worlds, n_steps, dev, inside, phase, toi=None,
                    on_step=None):
    """The sandwich's main path on one joint scene: launch counts and
    health; `toi` is step_batched's time-of-impact hook, and
    `on_step(states, events)` runs after each step. Returns (the launches,
    the recorder)."""
    import torch
    states = joint_batch(scene, size, n_worlds, dev)
    rec = SandwichRecorder()
    overflow = torch.zeros((), dtype=torch.int32, device=dev)

    def check(st, ev):
        overflow.copy_(torch.maximum(overflow, ev.color_overflow.max()))
        if on_step is not None:
            on_step(st, ev)

    label = f"{n_worlds} x {scene}({'' if size is None else size})"
    torch.cuda.synchronize()
    zero_launches()
    states, syncs = roll(states, n_steps, check=check, sandwich=rec.hook(), toi=toi)
    torch.cuda.synchronize()
    launches = read_launches(path=f"{label} x {n_steps}")
    n = len(rec.steps)                       # steps that solved
    want = dict(pack_packed=n, vel_iter_packed=MAIN["velocity_iterations"] * n,
                pos_iter_packed=MAIN["position_iterations"] * n, unpack_packed=n,
                solve_middle=0)
    if n <= 0 or any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"{label}: launches {launches}, expected {want}")
    b = states.bodies
    if not all(bool(torch.isfinite(t).all()) for t in (b.c, b.a, b.v, b.w)):
        raise AssertionError(f"{label}: NaN/inf in the body state")
    inside(states)
    print(f"phase {phase} {label} x {n_steps} steps, continuous=True: launches={launches}, "
          f"host syncs/step={syncs / n_steps:.2f}, max color overflow={int(overflow)}, "
          f"touching/world={float(states.contacts.touching.sum(1).float().mean()):.1f}, "
          f"awake bodies/world={float((b.awake & (b.body_type == 2)).sum(1).float().mean()):.1f}")
    return launches, rec


def ccd_goldens(dev):
    """Phase 13: the three CCD scenes as one batch of worlds on the card,
    through K2, against their C++ traces over the steps each bound reads;
    K2 against its plain version on the roll's busiest round."""
    import numpy as np
    import torch
    from box2d_mt_tpu_torch.models import scenes
    from box2d_mt_tpu_torch.state import concat_worlds
    from box2d_mt_tpu_torch.world import step_batched
    states = concat_worlds([getattr(scenes, name)(device=dev, **CCD_CAPACITY)
                            for name in CCD_GOLDENS])
    rec = Recorder()
    steps = max(n for _, n, _ in CCD_GOLDENS.values())
    kept = []
    zero_launches()
    for _ in range(steps):
        states, ev = step_batched(states, DT, velocity_iterations=8, position_iterations=3,
                                  toi=rec.time_of_impact)
        b = states.bodies
        kept.append(torch.cat([b.xf_p, b.a[..., None]], -1))
        kept.append(torch.stack([ev.color_overflow.to(torch.float32),
                                 ev.toi_begin.any(1).to(torch.float32)], -1)[:, None])
    got = torch.stack(kept[0::2]).cpu().numpy()          # (step, world, body, 3)
    flags = torch.stack(kept[1::2]).cpu().numpy()[:, :, 0]
    launches = read_launches(path=f"CCD goldens x {steps}")["toi"]
    if launches <= 0 or launches != len(rec.toi):
        raise AssertionError(f"CCD scenes: {launches} K2 launches for {len(rec.toi)} calls")
    for w, (name, (n_bodies, n_steps, limit)) in enumerate(CCD_GOLDENS.items()):
        ref = np.asarray([[rb[:3] for rb in json.loads(line)["bodies"]]   # x, y, angle
                          for line in open(ROOT / f"tests/golden/{name}_120.jsonl")])
        mine = got[:n_steps, w, n_bodies - 1::-1]        # reverse creation order
        err = float(np.abs(mine - ref[:n_steps]).max())
        overflow, impact = flags[:n_steps, w, 0].max(), flags[:n_steps, w, 1].max()
        print(f"phase 13 {name} on the card, steps 0-{n_steps - 1}: worst error "
              f"{err:.3g} (bound {limit}), color overflow {int(overflow)}, "
              f"TOI impact {bool(impact)}")
        if not err < limit or overflow != 0 or not impact:
            raise AssertionError(f"{name}: the C++ golden is not met")
    print(f"phase 13 K2 launches in the {steps}-step roll: {launches}")
    compare_toi(rec.busiest_toi(), "CCD scenes, busiest round", phase=13)


def lanes_by_mtype(blob, perm, color_start):
    """Solved lanes of each manifold type: (3,) on the device."""
    import torch
    used = torch.arange(perm.shape[1], device=perm.device) < color_start[:, -1:]
    mtype = blob[:, MTYPE_ROW].gather(1, perm.long())
    return torch.stack([((mtype == k) & used).sum() for k in range(len(MTYPES))])


def proxy_counts(lanes):
    """Active lanes by (vertex count of proxy A, of proxy B)."""
    import torch
    pairs = torch.stack([lanes[1], lanes[5]], 1)[lanes[-1]]
    keys, counts = torch.unique(pairs, dim=0, return_counts=True)
    return {tuple(k): int(n) for k, n in zip(keys.tolist(), counts.tolist())}


class CircleRecorder(Recorder):
    """Recorder that keeps every step's solve-middle arguments and their
    solved lanes by manifold type (a device tensor: no host read in the
    step)."""

    def __init__(self):
        super().__init__()
        self.middles = []

    def solve_middle(self, *args):
        self.middles.append((args, lanes_by_mtype(*args[:3])))
        return super().solve_middle(*args)

    def most_circles(self):
        """The recorded solve middle with the most e_circles lanes and its
        lanes by type."""
        import torch
        counts = torch.stack([c for _, c in self.middles]).tolist()
        i = max(range(len(counts)), key=lambda j: (counts[j][0], sum(counts[j])))
        return self.middles[i][0], dict(zip(MTYPES, counts[i]))

    def most_circle_proxies(self):
        """The recorded time-of-impact round with the most active lanes
        that have a circle (one-vertex) proxy."""
        n = [int((a[-1] & ((a[1] == 1) | (a[5] == 1))).sum()) for a, _ in self.toi]
        return self.toi[max(range(len(n)), key=n.__getitem__)][0], max(n)


def circle_stack(dev):
    """512 x sphere_stack(10) x 120 steps: K1 on circle-circle lanes, K2 on
    circle proxies against the edge ground, each held to its plain version
    and timed there."""
    import torch
    from box2d_mt_tpu_torch.ops import solve_middle as sm
    n_worlds, n_steps = 512, 120
    states = joint_batch("sphere_stack", 10, n_worlds, dev)
    rec = CircleRecorder()
    bad = torch.zeros((), dtype=torch.int32, device=dev)

    def check(st, ev):
        bad.copy_(torch.maximum(bad, torch.maximum(ev.color_overflow.max(),
                                                   ev.toi_overflow.max())))

    torch.cuda.synchronize()
    zero_launches()
    states, syncs = roll(states, n_steps, check=check, middle=rec.solve_middle,
                         toi=rec.time_of_impact)
    torch.cuda.synchronize()
    launches = read_launches(path=f"{n_worlds} x sphere_stack(10) x {n_steps}")
    b = states.bodies
    if min(launches[k] for k in ("solve_middle", "toi", "color_walk")) <= 0:
        raise AssertionError(f"sphere_stack did not launch every kernel: {launches}")
    if not all(bool(torch.isfinite(t).all()) for t in (b.c, b.a, b.v, b.w)):
        raise AssertionError("sphere_stack: NaN/inf in the body state")
    if int(bad) != 0:
        raise AssertionError("sphere_stack: color or TOI overflow")
    low = float(b.c[:, 1:11, 1].min())
    if not low > 0.5:
        raise AssertionError(f"sphere_stack: a circle fell through: center y {low}")
    print(f"phase 14 {n_worlds} x sphere_stack(10) x {n_steps} steps, continuous=True: "
          f"launches={launches}, host syncs/step={syncs / n_steps:.2f}, "
          f"lowest circle center y={low:.4f}, "
          f"touching/world={float(states.contacts.touching.sum(1).float().mean()):.1f}")
    args, by_type = rec.most_circles()
    if by_type["e_circles"] <= 0:
        raise AssertionError("sphere_stack: no e_circles lane was solved")
    compare_middle(args, f"512 x sphere_stack(10), the step with most e_circles "
                         f"lanes, solved lanes by type {by_type}", phase=14)
    lanes, n_circle = rec.most_circle_proxies()
    counts = proxy_counts(lanes)
    compare_toi(lanes, f"512 x sphere_stack(10), the round with most circle-proxy "
                       f"lanes ({n_circle}), active lanes by (vertices of A, of B) "
                       f"{counts}", phase=14)
    if n_circle <= 0:
        raise AssertionError("sphere_stack: no circle proxy reached K2")
    m = measure(sm.solve_middle, args)
    n_bytes, bnd = k1_bound(args)
    print(f"phase 14 solve_middle [512 x sphere_stack(10), {int(args[2][:, -1].sum())} solved "
          f"lanes]: {show(m, n_bytes)}; bound {bnd[0]:.5f} ms ({bnd[1]}: {n_bytes} B; device "
          f"time at {100 * bnd[0] / m['ms']:.2f}% of it); {middle_path(args)}")
    time_toi(lanes, "512 x sphere_stack(10), the circle round", phase=14)


def pinball_table(dev):
    """256 x pinball x 240 steps: the sandwich K3-K6 on a joint world with
    a bullet circle in a chain loop, and K2 against the chain's edges;
    K3-K6 held to their plain versions on its busiest step."""

    def ball_inside(states):
        c = states.bodies.c[:, 3]                     # ground, flippers, ball
        x, y = c[:, 0], c[:, 1]
        out = ~((y > x.abs() - 2.05) & (x.abs() < 8.05) & (y < 20.05))
        if bool(out.any()):
            raise AssertionError(f"pinball: a ball left the table in {int(out.sum())} worlds")

    launches, rec = run_joint_scene("pinball", None, 256, 240, dev, ball_inside, phase=14)
    if launches["toi"] <= 0:
        raise AssertionError(f"pinball: K2 was not launched: {launches}")
    step = rec.busiest()
    by_type = dict(zip(MTYPES, lanes_by_mtype(step["blob"], step["perm"],
                                              step["color_start"]).tolist()))
    compare_sandwich(step, f"256 x pinball, busiest step, solved lanes by type {by_type}",
                     phase=14)


def zoo_goldens(dev):
    """The zoo scenes of ZOO_GOLDENS as one batch of worlds on the card
    (8 velocity and 3 position iterations, the default color budget, as
    their JAX tests step them), and falling_circle alone at the 6 and 2
    iterations its golden was recorded at; each against its C++ trace.
    Raises when a bound is missed."""
    import numpy as np
    import torch
    from box2d_mt_tpu_torch.models import scenes
    from box2d_mt_tpu_torch.state import concat_worlds, map_leaves
    from box2d_mt_tpu_torch.world import possible_kinds
    names = list(ZOO_GOLDENS)
    states = concat_worlds([getattr(scenes, spec[0])(*spec[1], device=dev, **ZOO_CAPACITY)
                            for spec in ZOO_GOLDENS.values()])
    kinds = possible_kinds(states)
    window = [spec[4] for spec in ZOO_GOLDENS.values()]
    alive = list(range(len(names)))            # the batch's worlds, by index in names
    kept = []                                  # per step: (alive, poses, flags)
    t0 = time.perf_counter()
    for i in range(max(window)):
        # a world leaves the batch when its window ends
        if any(window[w] <= i for w in alive):
            rows = [r for r, w in enumerate(alive) if window[w] > i]
            alive = [alive[r] for r in rows]
            idx = torch.tensor(rows, device=dev)
            states = map_leaves(lambda t: t.index_select(0, idx), states)
        states, ev = checked_step(states, DT, velocity_iterations=8, position_iterations=3,
                                  kinds=kinds)
        b = states.bodies
        kept.append((alive, torch.cat([b.xf_p, b.a[..., None]], -1),
                     torch.stack([ev.color_overflow.to(torch.float32),
                                  (ev.begin_touch | ev.toi_begin).any(1).to(torch.float32),
                                  ev.end_touch.any(1).to(torch.float32)], -1)))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    awake = dict(zip(alive, states.bodies.awake.cpu().numpy()))

    def world_rows(w, n_steps):
        """World w's poses (step, body, 3) and flags (step, 3)."""
        rows = [(a.index(w), p, f) for a, p, f in kept[:n_steps]]
        return (torch.stack([p[r] for r, p, _ in rows]).cpu().numpy(),
                torch.stack([f[r] for r, _, f in rows]).cpu().numpy())

    print(f"phase 14 zoo goldens: {len(names)} worlds in one batch, each leaving it when "
          f"its window ends, {max(window)} steps ({elapsed:.3f} s)")
    for w, (name, (_, _, trace, n_bodies, n_steps, limit, last)) in enumerate(
            ZOO_GOLDENS.items()):
        ref = [json.loads(line) for line in open(ROOT / f"tests/golden/{trace}.jsonl")]
        got, flags = world_rows(w, n_steps)
        overflow = flags[:, 0].max()
        if n_bodies is None:                             # the sensor scene
            begins = np.flatnonzero(flags[:, 1]).tolist()
            ends = np.flatnonzero(flags[:, 2]).tolist()
            want_b = [r["step"] for r in ref if r.get("ev") == "begin"]
            want_e = [r["step"] for r in ref if r.get("ev") == "end"]
            final = [r for r in ref if "final" in r][0]["final"]
            err = abs(float(got[n_steps - 1, 2, 1]) - final[1])
            print(f"phase 14 golden {name}: sensor begin steps {begins} (C++ {want_b}), "
                  f"end steps {ends} (C++ {want_e}); ball's final height error {err:.3g} "
                  f"(bound {limit})")
            ok = begins == want_b and ends == want_e and err < limit
        else:
            mine = np.stack([got[:, n_bodies - 1 - j] for j in range(len(ref[0]["bodies"]))],
                            1)
            trace_xya = np.asarray([[rb[:3] for rb in r["bodies"]] for r in ref[:n_steps]])
            per_body = np.abs(mine - trace_xya).max(-1)          # (step, body)
            if name.startswith("sleep_collide_perf"):
                # the trace's body j is slot n_bodies - 1 - j: slots 1-42
                held = [j for j in range(per_body.shape[1]) if 1 <= n_bodies - 1 - j <= 42]
                per_body = per_body[:, held]
                asleep = not awake[w][1:43].any()
                ref_asleep = not any(ref[-1]["bodies"][j][6] for j in held)
            errs = per_body.max(1)
            ok = errs.max() < limit and (last is None or errs[-1] < last)
            extra = ""
            if name in ZOO_EARLY:
                n_early, early = ZOO_EARLY[name]
                ok = ok and errs[:n_early].max() < early
                extra = f", steps 0-{n_early - 1} {errs[:n_early].max():.3g} (bound {early})"
            if name.startswith("sleep_collide_perf"):
                ok = ok and asleep and ref_asleep
                extra = f", pyramids asleep {asleep} (C++ {ref_asleep})"
            if name.startswith("vertical_stack"):
                drift = float(np.abs(got[n_steps - 1, 1:6, 0]).max())
                ok = ok and drift < 0.05
                extra = f", largest |x| {drift:.3g} (bound 0.05)"
            print(f"phase 14 golden {name}, steps 0-{n_steps - 1}: worst error "
                  f"{errs.max():.3g} (bound {limit}), last step {errs[-1]:.3g} "
                  f"(bound {last}){extra}, color overflow {int(overflow)}")
        if not ok or overflow != 0:
            raise AssertionError(f"{name}: the C++ golden is not met")
    # falling_circle: 6 velocity and 2 position iterations
    states = scenes.falling_circle(device=dev)
    ref = [json.loads(line) for line in open(ROOT / "tests/golden/circle_120.jsonl")]
    kept = []
    for _ in range(120):
        states, ev = checked_step(states, DT, velocity_iterations=6, position_iterations=2)
        kept.append(torch.cat([states.bodies.xf_p[0, :2], states.bodies.a[0, :2, None]], -1))
    mine = torch.stack(kept).cpu().numpy()[:, ::-1]
    errs = np.abs(mine - np.asarray([[rb[:3] for rb in r["bodies"]] for r in ref])).max((1, 2))
    print(f"phase 14 golden falling_circle (6/2 iterations), steps 0-119: worst error "
          f"{errs.max():.3g} (bound 0.5), last step {errs[-1]:.3g} (bound 0.2)")
    if not (errs.max() < 0.5 and errs[-1] < 0.2):
        raise AssertionError("falling_circle: the C++ golden is not met")


def alike(builders, dev):
    """One batch of the worlds `builder(dev, **capacity)` makes, each frozen
    with the largest capacities of all of them."""
    from box2d_mt_tpu_torch.state import JOINT_BLOCKS, concat_worlds
    first = [build(dev) for build in builders]
    cap = dict(body_capacity=max(s.bodies.capacity for s in first),
               fixture_capacity=max(s.fixtures.capacity for s in first),
               contact_capacity=max(s.contacts.capacity for s in first),
               joint_capacity={name: max(getattr(s.joints, name).active.shape[1]
                                         for s in first) for name, _ in JOINT_BLOCKS})
    return concat_worlds([build(dev, **cap) for build in builders])


def scene_builder(name):
    from box2d_mt_tpu_torch.models import scenes
    return lambda dev, **cap: getattr(scenes, name)(device=dev, **cap)


def mouse_world(dev, **capacity):
    """The box resting on the ground of tests/test_runtime_api.py's mouse
    drag, held by a mouse joint (max_force 1000) at its center whose
    target is then set to (2.0, 0.5)."""
    import torch
    from box2d_mt_tpu_torch import settings, shapes
    from box2d_mt_tpu_torch.world import WorldBuilder
    wb = WorldBuilder(gravity=(0.0, -10.0))
    ground = wb.create_body()
    wb.create_fixture(ground, shapes.Edge((-40.0, 0.0), (40.0, 0.0)))
    box = wb.create_body(body_type=settings.DYNAMIC_BODY, position=(0.0, 0.5))
    wb.create_fixture(box, shapes.Polygon.box(0.5, 0.5), density=1.0, friction=0.1)
    wb.create_mouse_joint(box, (0.0, 0.5), max_force=1000.0)
    st = wb.freeze(device=dev, **capacity)
    mouse = st.joints.mouse
    target = mouse.target.clone()
    target[:, 0] = torch.tensor([2.0, 0.5], device=target.device)
    return dataclasses.replace(st, joints=dataclasses.replace(
        st.joints, mouse=dataclasses.replace(mouse, target=target)))


def car_path(dev):
    """256 x car x 120 steps, continuous=True: K3-K6 on the car's contacts
    and K2 on its wheels against the edge terrain. K3-K6 against their
    plain versions on the busiest step, K2 on the busiest round; car's
    C++ golden on world 0, rolled on alone for its last 120 steps."""
    def on_course(states):
        b = states.bodies
        low = float(b.c[..., 1][b.body_type == 2].min())
        ahead = float(b.c[:, CAR_CHASSIS, 0].min())
        print(f"phase 15 car: lowest body y {low:.3f}, chassis x in every world >= {ahead:.3f}")
        if not (low > -3.0 and ahead > 0.5):
            raise AssertionError(f"car: a body fell through the terrain or the car "
                                 f"did not drive off (y {low}, chassis x {ahead})")

    import torch
    kept, last = [], []

    def keep(st, ev):
        # world 0's poses: the first half of car's golden roll
        b = st.bodies
        kept.append((torch.cat([b.xf_p[:1], b.a[:1, :, None]], -1), ev.color_overflow[:1]))
        last[:] = [st]

    rec_toi = Recorder()
    launches, rec = run_joint_scene("car", None, 256, 120, dev, on_course, phase=15,
                                    toi=rec_toi.time_of_impact, on_step=keep)
    if launches["toi"] <= 0:
        raise AssertionError(f"car: K2 was not launched: {launches}")
    # the golden's other 120 steps on world 0 alone. The JAX test steps car
    # at the default color budget; with no color overflow in any step
    # (held_to_goldens checks it), the 16 of MAIN color it the same way
    from box2d_mt_tpu_torch.state import map_leaves
    states = map_leaves(lambda t: t[:1], last[0])
    t0 = time.perf_counter()
    for _ in range(120):
        states, ev = checked_step(states, DT, **MAIN)
        kept.append((torch.cat([states.bodies.xf_p, states.bodies.a[..., None]], -1),
                     ev.color_overflow))
    held_to_goldens(("car",), kept, time.perf_counter() - t0)
    step = rec.busiest()
    by_type = dict(zip(MTYPES, lanes_by_mtype(step["blob"], step["perm"],
                                              step["color_start"]).tolist()))
    compare_sandwich(step, f"256 x car, busiest step, solved lanes by type {by_type}",
                     phase=15)
    compare_toi(rec_toi.busiest_toi(), "256 x car, busiest round", phase=15)


def joint_types(dev, copies=4, compare_steps=20):
    """The mouse world and the scenes of TYPE_BATCH, each `copies` times,
    as one batch rolled 240 steps through the kernels at the default
    color budget, as the JAX tests step them: each scene held to its C++
    trace, the mouse box within 0.1 m of its target by step 120. Its
    first compare_steps steps again through the plain versions, held to
    the kernel path at that step (phase 11's rules). Rolled in inference
    mode; raises when a check fails."""
    import torch
    from box2d_mt_tpu_torch import settings
    from box2d_mt_tpu_torch.ops import solve_middle as sm
    from box2d_mt_tpu_torch.ops import toi as ktoi
    from box2d_mt_tpu_torch.state import JOINT_BLOCKS, replicate
    states = replicate(alike([mouse_world] + [scene_builder(n) for n in TYPE_BATCH], dev),
                       copies)
    n = 1 + len(TYPE_BATCH)
    target = torch.tensor([2.0, 0.5], device=dev)
    gap, kept = [], []

    def track(st, ev):
        c = st.bodies.c[0::n, 1]                             # the mouse worlds' box
        gap.append(torch.linalg.vector_norm(c - target, dim=-1).max())
        kept.append((torch.cat([st.bodies.xf_p, st.bodies.a[..., None]], -1)[1:n],
                     ev.color_overflow[1:n]))
        if len(kept) == compare_steps:
            at_compare.append(st)

    at_compare = []
    t0 = time.perf_counter()
    with torch.inference_mode():
        roll(states, 240, check=track, max_colors=settings.MAX_COLORS)
        ker = at_compare[0]
        el_ker = time.perf_counter() - t0
        pln, _ = roll(states, compare_steps, middle=sm.solve_middle_plain,
                      toi=ktoi.time_of_impact_lanes_plain, sandwich=sm.SANDWICH_PLAIN,
                      max_colors=settings.MAX_COLORS)
    d = {k: (getattr(ker.bodies, k) - getattr(pln.bodies, k)).abs().max().item()
         for k in ("c", "a", "v")}
    d["joint impulse"] = max(
        (getattr(getattr(ker.joints, name), f.name)
         - getattr(getattr(pln.joints, name), f.name)).abs().max().item()
        for name, cls in JOINT_BLOCKS for f in dataclasses.fields(cls)
        if f.name.endswith("impulse") and getattr(ker.joints, name).active.shape[1])
    awake_eq = bool(torch.equal(ker.bodies.awake, pln.bodies.awake))
    gaps = torch.stack(gap).tolist()
    within = next((i + 1 for i, g in enumerate(gaps) if g < 0.1), None)
    print(f"phase 15 {copies} x (mouse world + {', '.join(TYPE_BATCH)}): 240 steps through "
          f"the kernels {el_ker:.3f} s, {compare_steps} through the plain versions "
          f"{time.perf_counter() - t0 - el_ker:.3f} s; at step {compare_steps} "
          + " ".join(f"max|d {k}|={v:.3g}" for k, v in d.items())
          + f" awake_equal={awake_eq}; mouse box within 0.1 m of its target from step "
          f"{within}, {gaps[119]:.4f} m at step 120")
    if (d["c"] > 2e-5 or d["a"] > 2e-5 or d["v"] > 1e-4 or d["joint impulse"] > 1e-4
            or not awake_eq):
        raise AssertionError(f"joint types: kernel path and plain path disagree: {d}")
    if within is None or within > 120:
        raise AssertionError(f"the mouse box did not reach its target by step 120: {gaps}")
    held_to_goldens(TYPE_BATCH, kept, el_ker)


def held_to_goldens(names, kept, elapsed, phase=15):
    """World w of the roll `kept` (per step: poses (W, N, 3) and color
    overflow (W,)) against the C++ trace of JOINT_GOLDENS[names[w]];
    raises when a bound is missed."""
    import numpy as np
    import torch
    got = torch.stack([p for p, _ in kept]).cpu().numpy()         # (step, world, body, 3)
    overflow = torch.stack([o for _, o in kept]).cpu().numpy()      # (step, world)
    for w, name in enumerate(names):
        trace, n_bodies, limit, early, last = JOINT_GOLDENS[name]
        ref = np.asarray([[rb[:3] for rb in json.loads(line)["bodies"]]
                          for line in open(ROOT / f"tests/golden/{trace}.jsonl")])
        errs = np.abs(got[:, w, n_bodies - 1::-1] - ref[:240]).max((1, 2))
        read = 240 if limit is not None or last is not None else early[0]
        ok = ((limit is None or errs.max() < limit)
              and (early is None or errs[:early[0]].max() < early[1])
              and (last is None or errs[-1] < last) and overflow[:read, w].sum() == 0)
        print(f"phase {phase} golden {name} ({len(names)} in its batch, {elapsed:.3f} s)"
              + ("" if limit is None else f", steps 0-239: worst error {errs.max():.3g} "
                                          f"(bound {limit})")
              + ("" if early is None else f", steps 0-{early[0] - 1} "
                                          f"{errs[:early[0]].max():.3g} (bound {early[1]})")
              + f", last step {errs[-1]:.3g}"
              + ("" if last is None else f" (bound {last})")
              + f", color overflow {int(overflow[:read, w].sum())} in steps 0-{read - 1}, "
              f"{int(overflow[:, w].sum())} in all")
        if not ok:
            raise AssertionError(f"{name}: the C++ golden is not met")


# phase 16's large single worlds (the load the reference's multithreading
# was built for): (builder, its arguments, worlds, steps). multithread_demo
# is 2800 boxes in a container (N = F = 4096, C = 16384), tiles a pyramid
# of 210 boxes on 2000 static tiles (F = 4096, N = 256, C = 16384),
# many_bodies 10000 falling boxes over a wide ground (N = F = 16384,
# C = 65536; the bottom row lands near step 33, the second near 45)
LARGE = {"multithread_demo": (2800, 16, 120), "tiles": ((20, 200, 10), 32, 120),
         "many_bodies": (10000, 4, 60)}
# the two C++ goldens of the large scenes' small sizes (tests/golden/*.jsonl):
# builder, its arguments, bodies in the trace, the JAX package's bound
# (tests/test_golden_zoo.py:218-221, :242-247); one batch of the two
LARGE_GOLDENS = {"tiles": ((4, 20, 2), "tiles_240", 11, 0.05),
                 "multithread_demo": ((200,), "multithread_demo_240", 201, 0.05)}
LARGE_GOLDEN_CAPACITY = dict(body_capacity=256, fixture_capacity=256, contact_capacity=1024)
# the six ManyBodies variants' borders (tests/test_scene_zoo.py:170)
VARIANT_BORDERS = {1: 150.0, 2: 100.0, 3: 150.0, 4: 60.0, 5: 60.0, 6: 40.0}


def large_args(name):
    args = LARGE[name][0]
    return args if isinstance(args, tuple) else (args,)


def large_label(name):
    """e.g. '32 x tiles(20, 200, 10)'."""
    return f"{LARGE[name][1]} x {name}({', '.join(map(str, large_args(name)))})"


def large_scene(name, dev):
    from box2d_mt_tpu_torch.models import scenes
    return getattr(scenes, name)(*large_args(name), device=dev)


def grid_vs_allpairs(dev):
    """16(a): 4 x many_bodies(1200) (2048 fixture slots) at steps 0, 30 and
    60 of a roll: the grid `find_pairs` runs equals the all-pairs finder
    world by world to the bit, with no overflow; with two slots a bucket
    it overflows, and keeps unique pairs that all-pairs also finds. The
    overflow of the JAX package's grid (32 slots, low bits) is printed
    beside."""
    import torch
    from box2d_mt_tpu_torch.models import scenes
    from box2d_mt_tpu_torch.ops import broadphase as bp
    from box2d_mt_tpu_torch.state import replicate
    states = replicate(scenes.many_bodies(1200, device=dev), 4)
    nc, nf = states.contacts.capacity, states.fixtures.capacity
    for step in (0, 30, 60):
        if step:
            states, _ = roll(states, 30)
        ga, gb, g_over = bp.find_pairs_grid(states, nc, cell_slots=bp.GRID_CELL_SLOTS,
                                            spread=True)
        aa, ab, a_over = bp.find_pairs_allpairs(states, nc)
        _, _, over32 = bp.find_pairs_grid(states, nc)
        sa, sb, s_over = bp.find_pairs_grid(states, nc, cell_slots=2)
        torch.cuda.synchronize()
        equal = bool(torch.equal(ga, aa) and torch.equal(gb, ab))
        keys = lambda fa, fb, w: {(a, b) for a, b in zip(fa[w].tolist(), fb[w].tolist())
                                  if a >= 0}
        subset = all(len(keys(sa, sb, w)) == int((sa[w] >= 0).sum())
                     and keys(sa, sb, w) <= keys(aa, ab, w) for w in range(4))
        print(f"phase 16(a) 4 x many_bodies(1200), {nf} fixture slots, step {step}: "
              f"pairs/world {(aa >= 0).sum(1).tolist()}, grid ({bp.GRID_CELL_SLOTS} slots, "
              f"spread) == all-pairs world by world: {equal}, overflow {g_over.tolist()} "
              f"(all-pairs {a_over.tolist()}; JAX's 32 slots {over32.tolist()}); 2 slots: "
              f"overflow "
              f"{s_over.tolist()}, unique and a subset of all-pairs: {subset}")
        if not equal or int(g_over.max()) or int(a_over.max()):
            raise AssertionError(f"step {step}: the grid disagrees with all-pairs")
        if int(s_over.min()) <= 0 or not subset:
            raise AssertionError(f"step {step}: 2 slots a bucket did not overflow cleanly")


def large_path(name, dev, inside, phase):
    """One large scene's path, LARGE[name] worlds and steps through K1 and
    K2, counted from 0 just before the roll: no NaN, no pair overflow,
    `inside(states)`; host syncs a step, the launches and K1's path.
    Returns the recorder."""
    import torch
    from box2d_mt_tpu_torch.state import replicate
    _, n_worlds, n_steps = LARGE[name]
    states = replicate(large_scene(name, dev), n_worlds)
    rec = Recorder()
    over = torch.zeros(2, dtype=torch.int32, device=dev)

    def check(st, ev):
        over.copy_(torch.maximum(over, torch.stack([ev.pair_overflow.max(),
                                                    ev.color_overflow.max()])))

    label = large_label(name)
    torch.cuda.synchronize()
    zero_launches()
    states, syncs = roll(states, n_steps, check=check, middle=rec.solve_middle,
                         toi=rec.time_of_impact)
    torch.cuda.synchronize()
    launches = read_launches(path=f"{label} x {n_steps}")
    b = states.bodies
    if not all(bool(torch.isfinite(t).all()) for t in (b.c, b.a, b.v, b.w)):
        raise AssertionError(f"{label}: NaN/inf in the body state")
    pair_overflow, color_overflow = over.tolist()
    if launches["solve_middle"] <= 0 or launches["toi"] <= 0:
        raise AssertionError(f"{label}: K1 or K2 was not launched: {launches}")
    inside(states)
    print(f"phase {phase} {label} x {n_steps} steps, continuous=True: launches={launches}, "
          f"host syncs/step={syncs / n_steps:.2f}, "
          f"max pair overflow={pair_overflow}, max color overflow={color_overflow}, "
          f"touching/world={float(states.contacts.touching.sum(1).float().mean()):.1f}; "
          f"K1 (last step): {middle_path(rec.middle)}")
    if pair_overflow:
        raise AssertionError(f"{label}: pair overflow {pair_overflow}")
    return rec


def k1_time(args, label):
    """16(g): K1's device time (graph replay) and bound on recorded inputs."""
    from box2d_mt_tpu_torch.ops.solve_middle import solve_middle
    m = measure(solve_middle, args, profiler=False)
    n_bytes, bnd = k1_bound(args)
    print(f"phase 16(g) solve_middle [{label}, {int(args[2][:, -1].sum())} solved lanes]: "
          f"{show(m, n_bytes)}; bound {bnd[0]:.5f} ms ({bnd[1]}: {n_bytes} B; device time at "
          f"{100 * bnd[0] / m['ms']:.2f}% of it); {middle_path(args)}")


def many_bodies_variants(dev):
    """16(e): the six ManyBodies variants as one batch at common capacities,
    12 steps with `floater_drive` between them: no color or pair
    overflow, finite, every body inside its variant's border + 10."""
    import torch
    from box2d_mt_tpu_torch.models import scenes
    from box2d_mt_tpu_torch.state import concat_worlds
    from box2d_mt_tpu_torch.world import possible_kinds
    first = [scenes.many_bodies_variant(k, device=dev)[0] for k in VARIANT_BORDERS]
    cap = dict(body_capacity=max(st.bodies.capacity for st in first),
               fixture_capacity=max(st.fixtures.capacity for st in first),
               contact_capacity=max(st.contacts.capacity for st in first))
    built = [scenes.many_bodies_variant(k, device=dev, **cap) for k in VARIANT_BORDERS]
    states = concat_worlds([st for st, _ in built])
    aux = {key: torch.cat([a[key] for _, a in built]) for key in built[0][1]}
    kinds = possible_kinds(states)
    worst = torch.zeros(2, dtype=torch.int32, device=dev)
    for _ in range(12):
        states = scenes.floater_drive(states, aux, DT)
        states, ev = checked_step(states, DT, kinds=kinds, **MAIN)
        worst = torch.maximum(worst, torch.stack([ev.pair_overflow.max(),
                                                  ev.color_overflow.max()]))
    b = states.bodies
    live = b.body_type >= 0
    finite = bool(torch.isfinite(b.c[live]).all())
    reach = (b.c.abs().amax(-1) * live).amax(1).tolist()
    borders = list(VARIANT_BORDERS.values())
    inside = all(r < border + 10.0 for r, border in zip(reach, borders))
    print(f"phase 16(e) ManyBodies variants 1-6 as one batch ({cap}), 12 steps with "
          f"floater_drive: finite {finite}, max pair/color overflow {worst.tolist()}, "
          f"farthest |coordinate| by variant {[round(r, 2) for r in reach]} (borders + 10 "
          f"{[border + 10 for border in borders]})")
    if not finite or int(worst.max()) or not inside:
        raise AssertionError("a ManyBodies variant broke its invariants")


def large_goldens(dev):
    """16(f): tiles(4, 20, 2) and multithread_demo(200) as one batch for
    240 steps, each against its C++ trace under the JAX package's bound."""
    import numpy as np
    import torch
    from box2d_mt_tpu_torch.models import scenes
    from box2d_mt_tpu_torch.state import concat_worlds
    from box2d_mt_tpu_torch.world import possible_kinds
    states = concat_worlds([getattr(scenes, name)(*spec[0], device=dev,
                                                  **LARGE_GOLDEN_CAPACITY)
                            for name, spec in LARGE_GOLDENS.items()])
    kinds = possible_kinds(states)
    kept = []
    t0 = time.perf_counter()
    for _ in range(240):
        states, ev = checked_step(states, DT, velocity_iterations=8, position_iterations=3,
                                  kinds=kinds)
        b = states.bodies
        kept.append((torch.cat([b.xf_p, b.a[..., None]], -1), ev.color_overflow))
    got = torch.stack([p for p, _ in kept]).cpu().numpy()
    overflow = torch.stack([o for _, o in kept]).max(0).values.tolist()
    elapsed = time.perf_counter() - t0
    for w, (name, (args, trace, n_bodies, limit)) in enumerate(LARGE_GOLDENS.items()):
        ref = [json.loads(line) for line in open(ROOT / f"tests/golden/{trace}.jsonl")]
        want = np.asarray([[rb[:3] for rb in r["bodies"]] for r in ref[:240]])
        mine = got[:, w, n_bodies - 1::-1]
        errs = np.abs(mine - want).max((1, 2))
        print(f"phase 16(f) golden {name}({', '.join(map(str, args))}), steps 0-239 in a "
              f"batch of two ({elapsed:.3f} s): worst error {errs.max():.3g} (bound {limit}), "
              f"last step "
              f"{errs[-1]:.3g}, color overflow {overflow[w]}")
        if not errs.max() < limit or overflow[w]:
            raise AssertionError(f"{name}: the C++ golden is not met")


def large_worlds(dev):
    """Phase 16: the grid pair finder and the worlds whose bodies outgrow
    a block's shared memory."""
    import torch
    from box2d_mt_tpu_torch.ops import solve_middle as sm
    grid_vs_allpairs(dev)

    def boxes(states):
        b = states.bodies
        return b.c[b.body_type == 2]

    def boxes_in_container(states):
        c = boxes(states)
        far, low = float(c[:, 0].abs().max()), float(c[:, 1].min())
        if not (far < 52.0 and low > -0.1):
            raise AssertionError(f"a box left the container: |x| {far}, y {low}")

    def boxes_on_tiles(states):
        low = float(boxes(states)[:, 1].min())
        if not low > 0.4:
            raise AssertionError(f"a box fell into the tiles: center y {low}")

    def boxes_above_ground(states):
        low = float(boxes(states)[:, 1].min())
        if not low > 0.4:
            raise AssertionError(f"a box fell through the ground: center y {low}")

    rec = large_path("multithread_demo", dev, boxes_in_container, "16(b)")
    k1_time(rec.middle, f"{large_label('multithread_demo')}, last step")
    del rec
    large_path("tiles", dev, boxes_on_tiles, "16(c)")
    rec = large_path("many_bodies", dev, boxes_above_ground, "16(d)")
    args = rec.middle
    shapes = (sm.middle_shape(args[4].shape[-1], args[0].shape[-1], args[2].shape[-1] - 1),
              sm.sweep_shape(args[4].shape[-1], args[0].shape[-1], args[2].shape[-1] - 1))
    if not all(shape.global_planes for shape in shapes):
        raise AssertionError("many_bodies(10000) did not take the global planes")
    label = large_label("many_bodies")
    compare_middle(args, f"{label}, last step", phase="16(d)")
    compare_toi(rec.busiest_toi(), f"{label}, busiest round", phase="16(d)")
    sandwich_vs_k1(args, f"{label}, last step", phase="16(d)")
    k1_time(args, f"{label}, last step")
    del rec, args
    torch.cuda.empty_cache()
    many_bodies_variants(dev)
    large_goldens(dev)


# ---- phase 17: the PreSolve hook and between-step mutations

HOOK_PATHS = {"conveyor_belt": (256, 120), "one_sided_platform": (256, 120)}
# the goldens of phase 17(b): golden file, steps the bound reads, the JAX
# package's bound (tests/test_golden_interactive.py, tests/test_golden_zoo.py
# :321-335); breakable's bound reads the steps before its break
HOOK_GOLDENS = {"conveyor_belt": ("conveyor_belt_240", 240, 0.35),
                "one_sided_platform": ("one_sided_platform_240", 240, 0.05)}
MUTATION_GOLDENS = {"shape_editing": ("shape_editing_240", 240, 0.05),
                    "breakable": ("breakable_240", 167, 0.1),
                    "collision_processing": ("collision_processing_240", 240, 0.2),
                    "skier": ("skier_180", 180, 0.02)}
MUTATION_CAPACITY = dict(body_capacity=8, fixture_capacity=8, contact_capacity=64)
BREAK_STEP = 167


def belt_hook(states, view):
    """ConveyorBelt.h:67-84, batched: the platform (fixture 1) moves its
    contacts at 5 m/s."""
    return {"tangent_speed": ((view.f_a == 1) | (view.f_b == 1)) * 5.0}


def one_sided_hook(states, view):
    """OneSidedPlatform.h:PreSolve, batched: the platform's (body 1)
    contacts are off while the actor's (body 2) center is below its top."""
    below = states.bodies.c[:, 2, 1] < 10.5
    return ~(((view.body_a == 1) | (view.body_b == 1)) & below[:, None])


HOOKS = {"conveyor_belt": belt_hook, "one_sided_platform": one_sided_hook}


class BusiestRecorder(Recorder):
    """A Recorder that keeps every step's solve-middle inputs, to hold K1
    on the step with the most solved lanes."""

    def __init__(self):
        super().__init__()
        self.middles = []

    def solve_middle(self, *args):
        self.middles.append((args, args[2][:, -1].sum()))
        return super().solve_middle(*args)

    def busiest_middle(self):
        import torch
        lanes = torch.stack([n for _, n in self.middles]).tolist()
        return self.middles[max(range(len(lanes)), key=lanes.__getitem__)][0]


def hook_path(name, dev):
    """17(a): one hook world's path through K1 and K2, launches from 0;
    the conveyor also without its hook and with a hook that changes
    nothing, which must roll as without it."""
    import torch
    from box2d_mt_tpu_torch.models import scenes
    from box2d_mt_tpu_torch.state import replicate
    n_worlds, n_steps = HOOK_PATHS[name]
    hook = HOOKS[name]
    label = f"{n_worlds} x {name}"
    one = getattr(scenes, name)(device=dev)
    start = replicate(one, n_worlds)
    rec = BusiestRecorder()
    torch.cuda.synchronize()
    zero_launches()
    states, syncs = roll(start, n_steps, pre_solve_fn=hook, middle=rec.solve_middle,
                         toi=rec.time_of_impact)
    torch.cuda.synchronize()
    launches = read_launches(path=f"{label} x {n_steps} (hook)")
    b = states.bodies
    if not all(bool(torch.isfinite(t).all()) for t in (b.c, b.a, b.v, b.w)):
        raise AssertionError(f"{label}: NaN/inf in the body state")
    if min(launches[k] for k in ("solve_middle", "toi", "color_walk")) <= 0:
        raise AssertionError(f"{label}: K1, K2 or K7 was not launched: {launches}")
    if name == "conveyor_belt":
        moved = float((b.c[:, 2:7, 0] - start.bodies.c[:, 2:7, 0]).min())
        check = f"every box carried >= {moved:.3f} m"
        if not moved > 6.0:           # the C++ trace: 6.52 m
            raise AssertionError(f"{label}: the belt did not carry the boxes: {moved}")
    else:
        y = b.c[:, 2, 1]
        check = f"actor y in [{float(y.min()):.4f}, {float(y.max()):.4f}]"
        if not float((y - 11.005).abs().max()) < 0.05:
            raise AssertionError(f"{label}: the actor is not on the platform: {check}")
    print(f"phase 17(a) {label} x {n_steps} steps with its hook, continuous=True: "
          f"launches={launches}, host syncs/step={syncs / n_steps:.2f}; {check}")
    if name == "conveyor_belt":
        # without the hook the boxes settle on a still platform and sleep
        with torch.inference_mode():
            (e0, s0), (e1, s1) = (roll(replicate(one, n_worlds), n_steps, **kw) for kw in (
                {}, dict(pre_solve_fn=lambda st, v: {"tangent_speed": v.tangent_speed})))
        same = s0 == s1 and bool(torch.equal(e0.bodies.c, e1.bodies.c))
        print(f"phase 17(a) {label} without the hook and with a hook that changes nothing: "
              f"host syncs and states equal {same}")
        if not same:
            raise AssertionError(f"{label}: a hook that changes nothing changed the roll")
    compare_middle(rec.busiest_middle(), f"{label}, busiest step", phase="17(a)")
    compare_toi(rec.busiest_toi(), f"{label}, busiest round", phase="17(a)")


def golden_errors(kept, refs, names):
    """Worst error per world and step against the traces (bodies in
    reverse creation order, live slots only), or None at a step whose
    body count differs. kept: per step (positions+angles (W, N, 3), body
    types (W, N)) on the host."""
    import numpy as np
    errs = {n: [] for n in names}
    for i, (pa, bt) in enumerate(kept):
        for w, (n, ref) in enumerate(zip(names, refs)):
            if i >= len(ref):
                continue
            slots = [k for k in range(bt.shape[1] - 1, -1, -1) if bt[w, k] >= 0]
            rows = np.asarray([rb[:3] for rb in ref[i]["bodies"]])
            errs[n].append(None if len(slots) != len(rows) else
                           float(np.abs(pa[w, slots] - rows).max()))
    return errs


def hook_goldens(dev):
    """17(b): conveyor_belt_240 and one_sided_platform_240 as one batch
    under one hook (the belt in world 0, the one-sided platform in 1)."""
    import torch
    from box2d_mt_tpu_torch.models import scenes
    from box2d_mt_tpu_torch.state import concat_worlds

    def hook(states, view):
        conveyor = (torch.arange(states.n_worlds, device=view.f_a.device) == 0)[:, None]
        belt = belt_hook(states, view)["tangent_speed"] * conveyor
        return {"tangent_speed": belt,
                "enabled": one_sided_hook(states, view) | conveyor}

    names = list(HOOK_GOLDENS)
    states = concat_worlds([getattr(scenes, n)(device=dev) for n in names])
    refs = [[json.loads(line) for line in open(ROOT / f"tests/golden/{f}.jsonl")]
            for f, _, _ in HOOK_GOLDENS.values()]
    kept = []
    t0 = time.perf_counter()
    for _ in range(240):
        states, _ = checked_step(states, DT, pre_solve_fn=hook)
        b = states.bodies
        kept.append((torch.cat([b.xf_p, b.a[..., None]], -1), b.body_type))
    kept = [(p.cpu().numpy(), t.cpu().numpy()) for p, t in kept]
    elapsed = time.perf_counter() - t0
    report_goldens("17(b) hook golden", kept, refs, names, HOOK_GOLDENS, elapsed)


def report_goldens(label, kept, refs, names, spec, elapsed, extra=None):
    errs = golden_errors(kept, refs, names)
    for n, (_, steps, bound) in spec.items():
        e = errs[n]
        if any(x is None for x in e):
            raise AssertionError(f"{n}: the body count differs from the trace's")
        print(f"phase {label} {n} ({len(names)} in its batch, {elapsed:.3f} s): worst error "
              f"{max(e[:steps]):.4g} over steps 0-{steps - 1} (bound {bound}), {max(e):.4g} "
              f"over the trace{'' if extra is None else extra.get(n, '')}")
        if not max(e[:steps]) < bound:
            raise AssertionError(f"{n}: the C++ golden is not met")


def mutation_goldens(dev):
    """17(b): shape_editing, breakable, collision_processing and skier as
    one batch of four worlds, each driven between steps as its JAX test
    drives it, with batched indices (-1: leave the world alone)."""
    import numpy as np
    import torch
    from box2d_mt_tpu_torch import mutate, settings, shapes
    from box2d_mt_tpu_torch.models import scenes
    from box2d_mt_tpu_torch.state import concat_worlds
    names = list(MUTATION_GOLDENS)
    se, br, cp, sk = range(4)

    def at(w, i):
        t = torch.full((4,), -1, dtype=torch.long, device=dev)
        t[w] = int(i)
        return t

    st = concat_worlds([getattr(scenes, n)(device=dev, **MUTATION_CAPACITY) for n in names])
    st = mutate.set_transform(st, at(sk, 1), (-0.7, float(st.bodies.xf_p[sk, 1, 1])), 0.0)
    refs = [[json.loads(line) for line in open(ROOT / f"tests/golden/{f}.jsonl")]
            for f, _, _ in MUTATION_GOLDENS.values()]
    kept, fixture2, broke, do_break, break_step = [], None, False, False, -1
    velocity, angular = None, 0.0
    t0 = time.perf_counter()
    for i in range(240):
        if i == 60:
            st, fixture2 = mutate.add_fixture(st, at(se, 1), shapes.Circle(3.0, (0.5, -4.0)),
                                              density=10.0)
            st = mutate.set_awake(st, at(se, 1), True)
        elif i == 120:
            st = mutate.set_sensor(st, fixture2, True)
        elif i == 180:
            st = mutate.remove_fixture(st, fixture2)
            st = mutate.set_awake(st, at(se, 1), True)
        if do_break and not broke:
            # Breakable.h Break(): the second half becomes its own body, both
            # pieces at the velocities cached before the impact step
            center = st.bodies.c[br, 1].clone()
            st = mutate.remove_fixture(st, at(br, 2))
            only = torch.arange(4, device=dev) == br
            st, b2 = mutate.add_body(st, body_type=settings.DYNAMIC_BODY,
                                     position=st.bodies.xf_p[br, 1], angle=st.bodies.a[br, 1],
                                     worlds=only)
            b2 = int(b2[br])
            st, _ = mutate.add_fixture(st, at(br, b2),
                                       shapes.Polygon.box(0.5, 0.5, (0.5, 0.0), 0.0),
                                       density=1.0)
            for b in (1, b2):
                r = st.bodies.c[br, b] - center
                st = mutate.set_angular_velocity(st, at(br, b), angular)
                st = mutate.set_linear_velocity(
                    st, at(br, b), velocity + torch.stack([-angular * r[1], angular * r[0]]))
            broke, do_break, break_step = True, False, i
        if not broke:
            velocity, angular = st.bodies.v[br, 1].clone(), float(st.bodies.w[br, 1])
        st, ev = checked_step(st, DT)
        impulse = torch.maximum(ev.normal_impulse[br].max(), ev.toi_normal_impulse[br].max())
        if not broke and float(impulse) > 40.0:
            do_break = True
        b = st.bodies
        kept.append((torch.cat([b.xf_p, b.a[..., None]], -1).cpu().numpy(),
                     b.body_type.cpu().numpy()))
        # CollisionProcessing.h: the lighter body of each touching dynamic
        # pair is destroyed
        fa, fb = ev.f_a[cp].cpu().numpy(), ev.f_b[cp].cpu().numpy()
        fxb = st.fixtures.body[cp].cpu().numpy()
        inv_m, bt = b.inv_mass[cp].cpu().numpy(), kept[-1][1][cp]
        nuke = set()
        for ci in np.flatnonzero(ev.touching[cp].cpu().numpy()):
            ba, bb = int(fxb[fa[ci]]), int(fxb[fb[ci]])
            if min(ba, bb) >= 0 and min(bt[ba], bt[bb]) >= 0 and inv_m[ba] > 0 and inv_m[bb] > 0:
                nuke.add(ba if 1 / inv_m[bb] > 1 / inv_m[ba] else bb)
        for body in sorted(nuke):
            st = mutate.remove_body(st, at(cp, body))
    elapsed = time.perf_counter() - t0
    report_goldens("17(b) mutation golden", kept, refs, names, MUTATION_GOLDENS, elapsed,
                   {"breakable": f"; split at step {break_step}"})
    if break_step != BREAK_STEP:
        raise AssertionError(f"breakable split at step {break_step}, not {BREAK_STEP}")


def runtime_joints(dev, n_worlds=128, n_steps=60):
    """17(c): 128 x pyramid(6), each world with a revolute joint pinning one
    box to the ground and a distance joint between two others, added by
    `mutate` with different bodies in each world; 60 steps through K3-K6
    (and K2), each sandwich kernel held against its plain version on the
    busiest step."""
    import torch
    from box2d_mt_tpu_torch import mutate
    from box2d_mt_tpu_torch.models import scenes
    from box2d_mt_tpu_torch.state import replicate
    states = replicate(scenes.pyramid(6, device=dev,
                                      joint_capacity={"revolute": 2, "distance": 2}), n_worlds)
    k = torch.arange(n_worlds, device=dev) % 15 + 1      # boxes 1-15 of 21
    c = states.bodies.c
    w = torch.arange(n_worlds, device=dev)
    states, i_rev = mutate.add_revolute_joint(states, 0, k, c[w, k] + 0.5)
    states, i_dist = mutate.add_distance_joint(states, k + 3, k + 6, c[w, k + 3], c[w, k + 6])
    if bool((i_rev < 0).any()) or bool((i_dist < 0).any()):
        raise AssertionError("a runtime joint found no free slot")
    rec = SandwichRecorder()
    torch.cuda.synchronize()
    zero_launches()
    states, syncs = roll(states, n_steps, sandwich=rec.hook())
    torch.cuda.synchronize()
    launches = read_launches(path=f"{n_worlds} x pyramid(6) + runtime joints x {n_steps}")
    b = states.bodies
    if not all(bool(torch.isfinite(t).all()) for t in (b.c, b.a, b.v, b.w)):
        raise AssertionError("runtime joints: NaN/inf in the body state")
    if min(launches[n] for n in SANDWICH_NAMES) <= 0 or launches["solve_middle"]:
        raise AssertionError(f"runtime joints: launches {launches}")
    # the pinned box still turns about its anchor: the anchor's two images
    rj = states.joints.revolute
    xf = lambda body, local: (b.xf_p[w, body] + torch.stack(   # noqa: E731
        [torch.cos(b.a[w, body]) * local[:, 0] - torch.sin(b.a[w, body]) * local[:, 1],
         torch.sin(b.a[w, body]) * local[:, 0] + torch.cos(b.a[w, body]) * local[:, 1]], -1))
    gap = float((xf(k, rj.local_anchor_b[w, 0]) - xf(torch.zeros_like(k),
                                                      rj.local_anchor_a[w, 0])).norm(dim=-1).max())
    print(f"phase 17(c) {n_worlds} x pyramid(6) + a runtime revolute and distance joint x "
          f"{n_steps} steps: launches={launches}, host syncs/step={syncs / n_steps:.2f}, "
          f"revolute anchor gap {gap:.4f} m")
    if not gap < 0.05:
        raise AssertionError(f"runtime revolute joints do not hold: gap {gap}")
    compare_sandwich(rec.busiest(), f"{n_worlds} x pyramid(6) + runtime joints, busiest step",
                     phase="17(c)")


def query_lanes():
    """tests/golden/shapecast.jsonl as shape_cast's arguments (host numpy)."""
    import numpy as np
    rows = [json.loads(line) for line in open(ROOT / "tests/golden/shapecast.jsonl")]

    def proxy(d):
        v = np.zeros((8, 2), np.float32)
        vs = np.asarray(d["verts"], np.float32)
        v[:len(vs)] = vs
        return v, len(vs), d["radius"]

    a, b = [proxy(r["a"]) for r in rows], [proxy(r["b"]) for r in rows]
    xfa = np.asarray([r["xfa"] for r in rows], np.float32)
    xfb = np.asarray([r["xfb"] for r in rows], np.float32)
    lanes = (np.stack([x[0] for x in a]), np.asarray([x[1] for x in a], np.int32),
             np.asarray([x[2] for x in a], np.float32), xfa[:, 0:2], xfa[:, 2],
             np.stack([x[0] for x in b]), np.asarray([x[1] for x in b], np.int32),
             np.asarray([x[2] for x in b], np.float32), xfb[:, 0:2], xfb[:, 2],
             np.asarray([r["tr"] for r in rows], np.float32))
    return rows, lanes


def run_shape_cast(lanes, device):
    import torch
    from box2d_mt_tpu_torch import shape_cast
    from box2d_mt_tpu_torch.math2d import rot_from_angle
    t = [torch.from_numpy(x).to(device) for x in lanes]
    return [x.cpu().numpy() for x in shape_cast(
        t[0], t[1], t[2], t[3], rot_from_angle(t[4]), t[5], t[6], t[7], t[8],
        rot_from_angle(t[9]), t[10])]


def ray_world(device):
    """A circle, a rotated box, a rotated hull with a circle, and edges."""
    from box2d_mt_tpu_torch import settings, shapes
    from box2d_mt_tpu_torch.world import WorldBuilder
    wb = WorldBuilder(gravity=(0.0, 0.0))
    wb.create_fixture(wb.create_body(position=(5.0, 0.0)), shapes.Circle(1.0))
    wb.create_fixture(wb.create_body(position=(10.0, 0.0), angle=0.4),
                      shapes.Polygon.box(1.0, 0.5))
    g = wb.create_body()
    wb.create_fixture(g, shapes.Edge((14.0, -2.0), (14.0, 2.0)))
    wb.create_fixture(g, shapes.Edge((-4.0, -3.0), (20.0, -3.0)))
    b = wb.create_body(body_type=settings.DYNAMIC_BODY, position=(7.0, 3.0), angle=1.1)
    wb.create_fixture(b, shapes.Polygon.from_vertices(
        [(-1.0, 0.0), (1.0, -0.5), (1.5, 0.5), (0.0, 1.2), (-0.8, 0.9)]), density=1.0)
    wb.create_fixture(b, shapes.Circle(0.4, (0.3, -1.0)), density=1.0)
    return wb.freeze(device=device)


def queries_and_rope(dev, n_worlds=4096, n_ropes=1024):
    """17(d): the shape cast of the C++ fixtures, ray casts over 4096
    worlds (a ray each) and 1024 ropes on the card, each equal to the CPU
    result; the shape cast and the rope held to their C++ traces as the
    JAX package's tests hold them."""
    import numpy as np
    import torch
    from box2d_mt_tpu_torch import ray_cast_all, ray_cast_closest, rope
    from box2d_mt_tpu_torch.state import replicate
    rows, lanes = query_lanes()
    card, host = run_shape_cast(lanes, dev), run_shape_cast(lanes, "cpu")
    hit = host[0]
    # lambda and, where a lane hits, the point to 1e-5 and the normal (v / |v|
    # with |v| near the radii's sum) to 1e-4, as tests/test_torch_queries.py
    sc_err = max(float(np.abs(card[3] - host[3]).max()),
                 float(np.abs(card[1][hit] - host[1][hit]).max()))
    sc_n = float(np.abs(card[2][hit] - host[2][hit]).max())
    ref_hit = np.asarray([r["hit"] for r in rows]) > 0
    ref_lam = np.asarray([r["lambda"] for r in rows])
    both = card[0] & ref_hit & (ref_lam > 0)
    lam_bad = int((card[0] & ref_hit & (np.abs(card[3] - ref_lam) > 5e-3)).sum())
    # a lane whose |v| ends within rounding of the loop's tolerance may take
    # one trip more or less on the card; its lambda stays within 1e-5
    print(f"phase 17(d) shape_cast, {len(rows)} C++ fixtures on the card: hits equal to the "
          f"CPU's {np.array_equal(card[0], hit)}, iterations equal in "
          f"{int((card[4] == host[4]).sum())} lanes, max|d| lambda/point {sc_err:.3g}, normal "
          f"{sc_n:.3g}; against "
          f"C++: {int((card[0] != ref_hit).sum())} hit and {lam_bad} lambda mismatches")
    if (not np.array_equal(card[0], hit) or np.abs(card[4] - host[4]).max() > 1
            or sc_err > 1e-5 or sc_n > 1e-4
            or (card[0] != ref_hit).sum() > max(2, len(rows) // 50)
            or lam_bad > max(2, int(both.sum()) // 50)):
        raise AssertionError("shape_cast on the card disagrees")

    rng = np.random.default_rng(0)
    p1 = rng.uniform([-6.0, -5.0], [2.0, 6.0], (n_worlds, 2)).astype(np.float32)
    p2 = rng.uniform([8.0, -5.0], [22.0, 6.0], (n_worlds, 2)).astype(np.float32)
    out = {}
    for d in (dev, "cpu"):
        st = replicate(ray_world(d), n_worlds)
        a, b = torch.from_numpy(p1).to(d), torch.from_numpy(p2).to(d)
        out[str(d)] = [x.cpu().numpy() for x in (*ray_cast_all(st, a, b),
                                                  *ray_cast_closest(st, a, b))]
    gpu, cpu = out[str(dev)], out["cpu"]
    h = cpu[0]
    ray_err = max(float(np.abs(gpu[1][h] - cpu[1][h]).max()),
                  float(np.abs(gpu[8][cpu[4]] - cpu[8][cpu[4]]).max()))
    print(f"phase 17(d) ray casts, {n_worlds} worlds x {h.shape[1]} fixture slots, a ray "
          f"each: {int(h.sum())} hits, hit masks equal to the CPU's "
          f"{np.array_equal(gpu[0], h)}, closest fixtures equal "
          f"{np.array_equal(gpu[5], cpu[5])}, max|d fraction| {ray_err:.3g}")
    if not (np.array_equal(gpu[0], h) and np.array_equal(gpu[5], cpu[5])) or ray_err > 1e-5:
        raise AssertionError("ray casts on the card disagree with the CPU's")

    ref = [json.loads(line) for line in open(ROOT / "tests/golden/rope_pbd_240.jsonl")]

    def build(d):
        n = 40
        st = rope.make_rope([(0.0, 20.0 - 0.25 * i) for i in range(n)],
                            [0.0, 0.0] + [1.0] * (n - 2), gravity=(0.0, -10.0), damping=0.1,
                            k2=1.0, k3=0.5, device=d)
        return rope.set_angle(st, 0.25 * 3.14159265)

    # a rope step is ~3,600 small kernels and reads the host nothing, so
    # its launches are captured once in a CUDA graph and replayed
    ropes, one = rope.replicate(build(dev), n_ropes), build("cpu")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        rope.rope_step(ropes, DT, 1)                     # warm-up, off the graph
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        stepped = rope.rope_step(ropes, DT, 1)
    refs = torch.tensor([r["ps"] for r in ref[:240]], device=dev)
    errs = []
    t0 = time.perf_counter()
    for i in range(240):
        graph.replay()
        ropes.ps.copy_(stepped.ps)
        ropes.vs.copy_(stepped.vs)
        if i < 60:
            one = rope.rope_step(one, DT, 1)
        if i == 59:
            vs_cpu = float((ropes.ps.cpu() - one.ps).abs().max())
        errs.append((ropes.ps - refs[i]).abs().amax())
    errs = torch.stack(errs).cpu().numpy()
    elapsed = time.perf_counter() - t0
    print(f"phase 17(d) rope_pbd_240, {n_ropes} ropes x 240 steps on the card, each step a "
          f"replayed CUDA graph ({elapsed:.3f} s with 60 CPU steps beside): worst error "
          f"{errs[:60].max():.3g} over steps 0-59 "
          f"(bound 2e-3), {errs.max():.3g} over 240 (bound 0.05); max|card - CPU| at step "
          f"60 {vs_cpu:.3g}")
    if not (errs[:60].max() < 2e-3 and errs.max() < 0.05 and vs_cpu < 1e-4):
        raise AssertionError("the rope on the card misses its trace or the CPU's")


def hooks_and_mutations(dev):
    """Phase 17."""
    for name in HOOK_PATHS:
        hook_path(name, dev)
    hook_goldens(dev)
    mutation_goldens(dev)
    runtime_joints(dev)
    queries_and_rope(dev)


# phase 18: the joint goldens no earlier phase held (JOINT_GOLDENS) and
# theo_jansen, each rolled through the kernels for the 240 steps of its
# trace as a padded batch of CHECK_LANES lanes a scene, and its first
# CHECK_STEPS steps rolled again (tools/consistency_torch.run_batch): the
# same rolls are phase 19's check of these scenes. The four JOINT_GOLDENS
# scenes share a batch at max_colors=32, the most either package takes
# (the tumbler's JAX test asks for 48; at 32 its pile needs the overflow
# color late in the roll, none in steps 0-59, which its bound reads);
# theo_jansen rolls in a batch of its own at the default budget. The
# joint-free goldens no earlier phase held are rows of ZOO_GOLDENS
JOINT_GOLDEN_BATCH = (("collision_filtering", ()), ("dominos", ()), ("pinball", ()),
                      ("tumbler", (40,)))
# theo_jansen's trace holds 55 bodies; its bounds (tests/test_golden_zoo.py:
# 289-317): the chassis (slot 41) and the wheel (42) within 0.15 in x and
# y over the 240 steps, the twelve leg bodies (43-54) over steps 0-29
THEO_BODIES = 55
# phases 18-19: lanes a scene, and the steps both rolls share
CHECK_LANES, CHECK_STEPS = 4, 120
# phase 19: the heavier worlds beside the consistency list (name, scene,
# its arguments, worlds of it in one batch)
CONSISTENCY_HEAVY = (("64 x pyramid(10)", "pyramid", (10,), 64),
                     ("64 x sphere_stack(10)", "sphere_stack", (10,), 64),
                     ("16 x car", "car", (), 16),
                     ("4 x many_bodies(1200)", "many_bodies", (1200,), 4))
COUNTED = ("solve_middle", "toi") + SANDWICH_NAMES + ("color_walk", "toi_substep")


def consistency_tool():
    sys.path.insert(0, str(ROOT / "tools"))
    import consistency_torch
    return consistency_torch


_LAUNCHES = dict.fromkeys(COUNTED, 0)
_LAUNCH_LOCK = threading.Lock()


def zero_launches():
    """Count the CUDA launches of K1-K8 in this process from 0, at
    `cuda_build.call`, which every kernel's wrapper launches through and
    which the first call wraps: by the C entry's name less "_launch"
    (K7's "color_launch" as "color_walk"). A launch counts once it is
    taken, from any thread."""
    from box2d_mt_tpu_torch import cuda_build
    if not getattr(cuda_build.call, "counted", False):
        call = cuda_build.call

        def counted_call(source, name, *args, **kwargs):
            out = call(source, name, *args, **kwargs)
            kernel = "color_walk" if name == "color_launch" else name.removesuffix("_launch")
            with _LAUNCH_LOCK:
                _LAUNCHES[kernel] += 1
            return out

        counted_call.counted = True
        cuda_build.call = counted_call
    with _LAUNCH_LOCK:
        _LAUNCHES.update(dict.fromkeys(COUNTED, 0))


def read_launches(path=None):
    """The launches of each kernel since `zero_launches()`, kept in PATHS
    under `path` where one is given."""
    with _LAUNCH_LOCK:
        launches = dict(_LAUNCHES)
    if path is not None:
        PATHS[path] = launches
    return launches


def sync(dev):
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def golden_rolls(scenes_args, dev, **kw):
    """18: the scenes ((name, arguments) each) as one batch of CHECK_LANES
    lanes a scene, 240 steps through the kernels, and the first
    CHECK_STEPS again (consistency_torch.run_batch). Returns the
    consistency rows, per step the poses (S, N, 3) and the color overflow
    (S,) of each scene's first lane, the launches of both rolls, counted
    from 0 before them, and their seconds."""
    import torch
    from box2d_mt_tpu_torch.models import scenes
    entries = [(name, lambda device, _f=getattr(scenes, name), _a=args, **cap:
                _f(*_a, device=device, **cap), CHECK_LANES) for name, args in scenes_args]
    first = torch.arange(len(entries), device=dev) * CHECK_LANES
    kept = []

    def record(st, ev):
        kept.append((torch.cat([st.bodies.xf_p, st.bodies.a[..., None]], -1)[first],
                     ev.color_overflow[first]))

    sync(dev)
    zero_launches()
    t0 = time.perf_counter()
    rows = consistency_tool().run_batch(entries, CHECK_STEPS, dev, on_step=record,
                                        longer=240 - CHECK_STEPS, **kw)
    sync(dev)
    return rows, kept, read_launches(), time.perf_counter() - t0


def joint_goldens(dev):
    """18: the scenes of JOINT_GOLDEN_BATCH held to JOINT_GOLDENS, the
    tumbler's overflow color in use after step 59. Returns the
    consistency rows and the launches."""
    import torch
    names = [name for name, _ in JOINT_GOLDEN_BATCH]
    rows, kept, launches, elapsed = golden_rolls(JOINT_GOLDEN_BATCH, dev, max_colors=32)
    print(f"phase 18 joint goldens: {len(names)} scenes x {CHECK_LANES} lanes in one batch, "
          f"240 steps and the first {CHECK_STEPS} again, {elapsed:.3f} s, launches={launches}")
    held_to_goldens(names, kept, elapsed, phase=18)
    late = int(torch.stack([o for _, o in kept])[60:, names.index("tumbler")].sum())
    print(f"phase 18 tumbler(40) at 32 colors: the overflow color in use on {late} steps "
          f"after step 59")
    if late == 0:
        raise AssertionError("tumbler(40) at 32 colors: the overflow color is never used")
    return rows, launches


def theo_jansen_errors(poses):
    """theo_jansen's measure of poses (step, body slot, 3): the worst x or
    y error of the chassis and the wheel over the 240 steps, and of the
    twelve leg bodies over steps 0-29."""
    import numpy as np
    ref = np.asarray([[rb[:2] for rb in json.loads(line)["bodies"]]
                      for line in open(ROOT / "tests/golden/theo_jansen_240.jsonl")])
    xy = np.abs(poses[:, THEO_BODIES - 1::-1, :2] - ref[:240])    # reverse creation order
    core = xy[:, [THEO_BODIES - 1 - 41, THEO_BODIES - 1 - 42]].max()
    legs = xy[:30, THEO_BODIES - 1 - 54:THEO_BODIES - 1 - 42].max()
    return float(core), float(legs)


def theo_golden(dev):
    """18: theo_jansen held to its C++ trace (theo_jansen_errors, both
    within 0.15) with no color overflow. Returns the consistency rows and
    the launches."""
    import numpy as np
    import torch
    rows, kept, launches, elapsed = golden_rolls((("theo_jansen", ()),), dev)
    poses = torch.stack([p[0] for p, _ in kept]).cpu().numpy()
    overflow = int(torch.stack([o[0] for _, o in kept]).sum())
    core, legs = theo_jansen_errors(poses)
    print(f"phase 18 golden theo_jansen ({CHECK_LANES} lanes, 240 steps and the first "
          f"{CHECK_STEPS} again, {elapsed:.3f} s, launches={launches}): chassis and wheel "
          f"{core:.4g} over steps 0-239 (bound 0.15), legs {legs:.4g} over steps 0-29 (bound "
          f"0.15); color overflow {overflow}")
    if not (core < 0.15 and legs < 0.15 and overflow == 0 and np.isfinite(poses).all()):
        raise AssertionError("theo_jansen: the C++ golden is not met")
    return rows, launches


def add_pair_vs_cpu(dev, n_steps=16):
    """18: add_pair(50, 7) through the kernels against the port's roll on
    the host's CPU (tier-1 holds the CPU roll to the JAX package's), step
    by step through step 15, the last before the bullet's impact: c and a
    to 2e-5, v and w to 1e-4, awake and the pair table equal. Four more
    steps on the card give the C++ golden's error over steps 0-19 (the
    JAX test's first bound, 1e-3, which neither package meets)."""
    import numpy as np
    import torch
    from box2d_mt_tpu_torch.models import scenes
    from box2d_mt_tpu_torch.world import possible_kinds, step_batched
    card = scenes.add_pair(50, 7, device=dev)
    host = scenes.add_pair(50, 7, device="cpu")
    kinds = possible_kinds(host)
    ref = [json.loads(line) for line in open(ROOT / "tests/golden/add_pair_120.jsonl")]
    worst, errs = {}, []
    t0 = time.perf_counter()
    for i in range(20):
        card, _ = checked_step(card, DT, kinds=kinds)
        b = card.bodies
        kept = [(torch.cat([b.xf_p, b.a[..., None]], -1).cpu().numpy(),
                 b.body_type.cpu().numpy())]
        errs.append(golden_errors(kept, [ref[i:i + 1]], ["add_pair"])["add_pair"][0])
        if i >= n_steps:
            continue
        with torch.inference_mode():
            host, _ = step_batched(host, DT, kinds=kinds)
        for k in ("c", "a", "v", "w"):
            worst[k] = max(worst.get(k, 0.0), float((getattr(b, k).cpu()
                                                     - getattr(host.bodies, k)).abs().max()))
        same = (torch.equal(b.awake.cpu(), host.bodies.awake)
                and torch.equal(card.contacts.f_a.cpu(), host.contacts.f_a)
                and torch.equal(card.contacts.f_b.cpu(), host.contacts.f_b))
        if not same:
            raise AssertionError(f"add_pair: awake or the pair table differs at step {i}")
    print(f"phase 18 add_pair(50, 7), the card against the CPU over steps 0-{n_steps - 1}: "
          + " ".join(f"max|d {k}|={v:.3g}" for k, v in worst.items())
          + f", awake and pairs equal; C++ golden error over steps 0-19 "
          f"{max(errs):.4g} (JAX bound 1e-3, met by neither package) "
          f"({time.perf_counter() - t0:.3f} s)")
    if (worst["c"] > 2e-5 or worst["a"] > 2e-5 or worst["v"] > 1e-4 or worst["w"] > 1e-4
            or any(e is None for e in errs) or not np.isfinite(errs).all()):
        raise AssertionError(f"add_pair: the card and the CPU disagree: {worst}")


# phases 18 and 19 run side by side in worker processes on the one card:
# their rolls are bound by the host (a joint world's eager passes and a
# bullet world's TOI sub-steps launch thousands of small kernels a step),
# so each worker takes a CPU core
PARALLEL_WORKERS = 6


def consistency_entries(dev):
    """Phase 19's (name, build, worlds) entries: tools/consistency_torch.py's
    list at CHECK_LANES lanes but the scenes phase 18's rolls check, then
    CONSISTENCY_HEAVY."""
    from box2d_mt_tpu_torch.models import scenes
    held = {name for name, _ in JOINT_GOLDEN_BATCH} | {"theo_jansen"}
    entries = [(name, build, CHECK_LANES)
               for name, build, _ in consistency_tool().scene_list(CHECK_STEPS)
               if name not in held]
    for label, scene, args, n in CONSISTENCY_HEAVY:
        build = getattr(scenes, scene)
        entries.append((label, lambda device, _b=build, _a=args, **cap: _b(*_a, device=device,
                                                                            **cap), n))
    return entries


def check_task(task, dev):
    """One task of phases 18-19 in a worker process: ("joint goldens"),
    ("theo_jansen"), ("add_pair"), ("mutation") or ("batch", entry names)
    of phase 19. Returns (task, consistency rows, launches or None, printed
    text, seconds); a failure raises."""
    import contextlib
    import io
    import torch
    from box2d_mt_tpu_torch import cuda_build
    torch.set_num_threads(1)
    dev = torch.device(dev)
    if dev.type == "cuda":
        for name in SOURCES:
            cuda_build.build(name)                    # built by phase 1: loads it
    ct = consistency_tool()
    text = io.StringIO()
    t0 = time.perf_counter()
    rows, launches = [], None
    with contextlib.redirect_stdout(text):
        if task[0] == "joint goldens":
            rows, launches = joint_goldens(dev)
        elif task[0] == "theo_jansen":
            rows, launches = theo_golden(dev)
        elif task[0] == "add_pair":
            add_pair_vs_cpu(dev)
        elif task[0] == "mutation":
            rows = [ct.run_mutation_sequence(lanes=CHECK_LANES, device=dev)]
        else:
            entries = {e[0]: e for e in consistency_entries(dev)}
            zero_launches()
            rows = ct.run_batch([entries[n] for n in task[1]], CHECK_STEPS, dev)
            sync(dev)
            launches = read_launches()
            print(f"phase 19 {', '.join(task[1])} ({sum(r['lanes'] for r in rows)} worlds in "
                  f"one batch), 2 x {CHECK_STEPS} steps: {time.perf_counter() - t0:.3f} s, "
                  f"{rows[0]['worlds_steps_per_s']} worlds*steps/s")
    return task, rows, launches, text.getvalue(), time.perf_counter() - t0


def checks_in_parallel(dev, phases=("18", "19")):
    """Phases 18 (joint_goldens, theo_golden, add_pair_vs_cpu) and 19
    (tools/consistency_torch.py on the card: consistency_entries in the
    padded batches of `batch_groups`, and the mutation sequence replayed
    twice) as the tasks of one pool of PARALLEL_WORKERS processes, phase
    18's first, then phase 19's batches, the most scenes first. Phase 19
    reads phase 18's rolls too: every scene's rows equal run to run and
    lane to lane. Raises on any failure. Keeps the launches of the phases'
    paths, each counted from 0 before its rolls in its worker, in PATHS."""
    import concurrent.futures as cf
    import multiprocessing
    tasks = []
    if "18" in phases:
        tasks += [("joint goldens",), ("theo_jansen",), ("add_pair",)]
    if "19" in phases:
        groups = consistency_tool().batch_groups(consistency_entries(dev), dev)
        tasks += [("batch", tuple(e[0] for e in g))
                  for g in sorted(groups, key=len, reverse=True)]
        tasks.append(("mutation",))
    t0 = time.perf_counter()
    done = []
    workers = min(PARALLEL_WORKERS, len(tasks))
    with cf.ProcessPoolExecutor(workers,
                                mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = [pool.submit(check_task, t, str(dev)) for t in tasks]
        try:
            for f in cf.as_completed(futures):
                done.append(f.result())
        except BaseException:
            for f in futures:
                f.cancel()
            raise
    wall = time.perf_counter() - t0
    done.sort(key=lambda r: tasks.index(r[0]))
    paths, rows, busy = {}, [], {"18": 0.0, "19": 0.0}
    list_path = f"phase 19 consistency list x {CHECK_STEPS} (two rolls)"
    for task, task_rows, launches, text, seconds in done:
        print(text, end="")
        rows += task_rows
        phase = "19" if task[0] in ("batch", "mutation") else "18"
        busy[phase] += seconds
        if task[0] in ("joint goldens", "theo_jansen"):
            label = f"phase 18 {task[0]} x 240 (and {CHECK_STEPS} again)"
            paths[label] = launches
            want = ("toi",) + SANDWICH_NAMES if task[0] == "joint goldens" else SANDWICH_NAMES
            if min(launches[k] for k in want) <= 0:
                raise AssertionError(f"{label}: a kernel of its path was not launched: "
                                     f"{launches}")
        elif task[0] == "batch":
            total = paths.setdefault(list_path, dict.fromkeys(COUNTED, 0))
            for k, v in launches.items():
                total[k] += v
    failed = [r["scene"] + "".join(f" {k}" for k in ("rerun_bitexact", "lanes_bitexact",
                                                     "no_nan") if not r[k])
              for r in rows if not r["passed"]]
    print(f"phase{'s' * (len(phases) > 1)} {'-'.join(phases)} in {workers} worker processes: "
          f"{wall:.1f} s wall, "
          + ", ".join(f"phase {p} {busy[p]:.1f} s of worker time" for p in phases))
    print(f"bit reproducibility on the card ({CHECK_LANES} lanes, {CHECK_STEPS} steps rolled "
          f"twice): {len(rows)} scenes, failed {failed}"
          + (f", phase 19's launches={paths[list_path]}" if "19" in phases else ""))
    if failed:
        raise AssertionError(f"not bit-reproducible on the card: {failed}")
    if "19" in phases and min(paths[list_path].values()) <= 0:
        raise AssertionError(f"phase 19: a kernel was not launched: {paths[list_path]}")
    PATHS.update(paths)


# phase 20: (scene, size, worlds, steps, timed) sharded, and the warm-up
# steps before a timed roll (a new shard layout's first allocations). The
# rolls that are not timed run in inference mode (the same values, less
# host time)
SHARDED = (("pyramid", 10, 512, 60, True), ("car", None, 256, 60, False))
SHARD_WARMUP = 3


def differing_worlds(a, b):
    """The worlds in which two States (or two Events) differ in any leaf,
    bit for bit."""
    import torch
    from box2d_mt_tpu_torch.state import map_leaves
    from box2d_mt_tpu_torch.world import Events
    if isinstance(a, Events):
        pairs = [(getattr(a, f), getattr(b, f)) for f in Events._fields[:-1]]
    else:
        rest = []
        map_leaves(lambda t: rest.append(t) or t, b)
        it = iter(rest)
        pairs = []
        map_leaves(lambda t: pairs.append((t, next(it))) or t, a)
    bits = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t
    bad = torch.zeros(pairs[0][0].shape[0], dtype=torch.bool, device=pairs[0][0].device)
    for x, y in pairs:
        bad |= (bits(x) != bits(y)).reshape(x.shape[0], -1).any(1)
    return bad.nonzero().flatten().tolist()


def sharded_roll(devices, states, n_steps, count=False, warmup=SHARD_WARMUP):
    """n_steps of make_sharded_step(devices, **MAIN) from `states`, after
    `warmup` steps of a copy on the same shard threads. Returns the
    gathered State, the last Events, host syncs a step (summed over the
    shards), the seconds of the n_steps and, with `count`, the launches
    counted from 0 just before them."""
    import torch
    from box2d_mt_tpu_torch.parallel import sharding
    step, shard = sharding.make_sharded_step(devices, **MAIN)
    try:
        warm = shard(states)
        for _ in range(warmup):
            warm, _ = step(warm, DT)
        del warm
        st = shard(states)
        torch.cuda.synchronize()
        if count:
            zero_launches()
        syncs = 0
        t0 = time.perf_counter()
        for _ in range(n_steps):
            st, ev = step(st, DT)
            syncs += sum(e.host_syncs for e in ev.shards)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_launches() if count else None
        return st.gather(), ev.gather(), syncs / n_steps, seconds, launches
    finally:
        step.close()


def sharded_path(dev):
    """Phase 20: SHARDED's rolls over two shards on one card (and over
    every card where there are more), each world held bit for bit to the
    unsharded roll. Keeps the launches of the two-shard rolls in PATHS."""
    import torch
    from box2d_mt_tpu_torch.world import step_batched
    layouts = [("2 shards on cuda:0", [dev, dev], True)]
    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        layouts.append((f"{n_cards} shards, one a card",
                        [torch.device("cuda", i) for i in range(n_cards)], False))
    card = card_line()
    for scene, size, n_worlds, n_steps, timed in SHARDED:
        name = scene if size is None else f"{scene}({size})"
        mode = contextlib.nullcontext() if timed else torch.inference_mode()
        warmup = SHARD_WARMUP if timed else 0
        with mode:
            base = joint_batch(scene, size, n_worlds, dev)
            st = base
            for _ in range(warmup):
                st, _ = step_batched(st, DT, **MAIN)
            torch.cuda.synchronize()
            syncs = 0
            t0 = time.perf_counter()
            st = base
            for _ in range(n_steps):
                st, ev = step_batched(st, DT, **MAIN)
                syncs += ev.host_syncs
            torch.cuda.synchronize()
        rates = {"unsharded": (n_worlds * n_steps / (time.perf_counter() - t0),
                               syncs / n_steps)}
        ref, ref_ev = st, ev
        runs = list(layouts)
        if timed:
            runs.insert(0, ("1 shard", [dev], False))
        for label, devices, count in runs:
            with mode:
                got, got_ev, per_step, seconds, launches = sharded_roll(
                    devices, base, n_steps, count, warmup)
            bad, bad_ev = differing_worlds(got, ref), differing_worlds(got_ev, ref_ev)
            rates[label] = (n_worlds * n_steps / seconds, per_step)
            print(f"phase 20 {n_worlds} x {name} x {n_steps}, {label}: {seconds:.3f} s, "
                  f"{rates[label][0]:.1f} worlds*steps/s, host syncs/step {per_step:.2f} "
                  f"(summed over the shards); worlds differing from the unsharded roll: "
                  f"state {bad}, last events {bad_ev}"
                  + (f", launches={launches}" if launches else ""))
            if bad or bad_ev:
                raise AssertionError(f"{name}, {label}: worlds {sorted(set(bad + bad_ev))} "
                                     f"differ from the unsharded roll")
            if launches is not None:
                want = ("solve_middle", "toi") if scene == "pyramid" else \
                    ("toi",) + SANDWICH_NAMES
                if min(launches[k] for k in want) <= 0:
                    raise AssertionError(f"{name}, {label}: a kernel of its path was not "
                                         f"launched: {launches}")
                PATHS[f"phase 20 {n_worlds} x {name} x {n_steps}, {label}"] = launches
        print(f"phase 20 {n_worlds} x {name} x {n_steps} worlds*steps/s (host syncs/step"
              + ("" if timed else "; inference mode") + "): "
              + ", ".join(f"{k} {v[0]:.1f} ({v[1]:.2f})" for k, v in rates.items())
              + f"; card: {card}")


def coloring_kernel(dev):
    """Phase 21: K7 on 512 x pyramid(20)'s recorded colorings and on the
    tumbler's; held to `_luby` bit for bit (the phase raises on any
    difference), counted and timed."""
    import torch
    from box2d_mt_tpu_torch import trace
    from box2d_mt_tpu_torch.ops import coloring
    from box2d_mt_tpu_torch.ops.sync import HostSyncs
    plain_color = coloring.color_constraints
    calls = []

    def recorded(*args, **kwargs):
        calls.append(args[:7])
        return plain_color(*args, **kwargs)

    for label, states, n_steps in (("512 x pyramid(20)", batch(20, 512, dev), 60),
                                   ("256 x tumbler(200)",
                                    joint_batch("tumbler", 200, 256, dev), 30)):
        coloring.color_constraints = recorded
        sync(dev)
        zero_launches()
        try:
            with trace.collect() as c:
                roll(states, n_steps)
        finally:
            coloring.color_constraints = plain_color
        sync(dev)
        launches = read_launches(path=f"phase 21 {label} x {n_steps}")
        ev = c.events
        print(f"phase 21 {label} x {n_steps}: K7 launches {launches['color_walk']}, "
              f"coloring.kernel {ev['coloring.kernel']}, "
              f"coloring.runs {ev['coloring.runs']}, host reads a step "
              f"{c.host_syncs / c.steps:.3f}, reads in b2.coloring "
              f"{c.reads.get('b2.coloring', 0)}")
        if ev["coloring.kernel"] < max(1, ev["coloring.runs"]):
            raise AssertionError(f"{label}: a coloring missed K7: {ev}")
        if launches["color_walk"] != ev["coloring.kernel"]:
            raise AssertionError(f"{label}: {launches['color_walk']} K7 launches, "
                                 f"coloring.kernel {ev['coloring.kernel']}")
        if label.startswith("512"):
            main_calls, calls[:] = list(calls), []
    args = max(main_calls, key=lambda a: int(a[4].sum()))
    (ba, bb, dyn_a, dyn_b, active, n, _), lanes = args, args[:5]
    w, k = ba.shape
    print(f"phase 21 the busiest coloring: {w} worlds, K = {k}, N = {n}, "
          f"{int(active.sum()) / w:.1f} active slots a world")
    for mc in (16, 3):
        got = coloring.color_walk(*lanes, n, mc)
        want = coloring._luby(*lanes, n, mc, HostSyncs())
        sync(dev)
        for x, y, name in zip(got, want, ("color", "overflow", "rank")):
            if not torch.equal(x, y):
                raise AssertionError(f"K7 != _luby in {name} at max_colors={mc}")
        print(f"phase 21 K7 == _luby at max_colors={mc}: colors used "
              f"{int(got[0].max()) + 1}, overflow slots {int(got[1].sum())}")
    m = measure(lambda *a: coloring.color_walk(*a, n, 16), lanes)
    plain = time_call(lambda *a: coloring._luby(*a, n, 16, HostSyncs()), lanes, reps=3)
    n_bytes = w * k * (2 * 8 + 3 + 2 * 4) + w * 4
    bnd = least_ms(n_bytes)
    print(f"phase 21 K7 [{w} x K {k} x N {n}]: {show(m, n_bytes)}; plain _luby "
          f"{plain:.3f} ms (events around eager calls); bound {bnd[0]:.5f} ms ({bnd[1]}, "
          f"{n_bytes / 1e6:.2f} MB), {100 * bnd[0] / m['ms']:.2f}% of it")
    keep_worst("color_walk", 0.0)
    TIMES["color_walk"] = (m, plain, bnd, None)


def substep_bytes(args):
    """Bytes K8 must move for this call, each read or written once: every
    lane's solve flag, span, pose and velocity in and its pose, velocity
    and impulses out; a solved lane's manifold type and count, manifold,
    masses, centers, radii and material; every neighbor's parent, and an
    unkept one's velocity in and impulses and velocity out; a kept one's
    place in nb_order, its fields and its outputs."""
    solve, nb_parent = args[0], args[8]
    n_lanes, n_nb = solve.numel(), nb_parent.numel()
    solved, kept = int(solve.sum()), int((nb_parent >= 0).sum())
    lane = 1 + 2 * 4 + 2 * 6 * 4 + (6 + 6 + 4) * 4
    lane_solved = (2 + 8 + 10 + 3) * 4
    nb = 4
    nb_unkept = 3 * 4 + (4 + 3) * 4
    nb_kept = 4 + (4 + 8 + 14 + 3 + 6) * 4 + (4 + 3) * 4
    return (n_lanes * lane + solved * lane_solved + n_nb * nb
            + (n_nb - kept) * nb_unkept + kept * nb_kept)


def substep_kernel(dev):
    """Phase 22: K8 on the recorded sub-steps of 16 x multithread_demo(2800)
    and 512 x pyramid(20); held to the plain version bit for bit (the phase
    raises on any difference), counted and timed; the record keeps its
    times at the multithread sub-step."""
    import torch
    from box2d_mt_tpu_torch import trace
    from box2d_mt_tpu_torch.models import scenes
    from box2d_mt_tpu_torch.ops import toi as ktoi
    from box2d_mt_tpu_torch.state import replicate
    results = {}
    plain_passes = ktoi.toi_substep_passes_plain
    for label, make, n_steps in (
            ("16 x multithread_demo(2800)",
             lambda: replicate(scenes.multithread_demo(2800, device=dev), 16), 40),
            ("512 x pyramid(20)", lambda: batch(20, 512, dev), 60)):
        calls = []
        states = make()
        sync(dev)
        zero_launches()
        launch = ktoi._substep_launch

        def recorded(args, iterations, launch=launch, calls=calls):
            calls.append((tuple(a.clone() for a in args), iterations))
            return launch(args, iterations)

        ktoi._substep_launch = recorded
        try:
            with trace.collect() as c:
                roll(states, n_steps)
        finally:
            ktoi._substep_launch = launch
        sync(dev)
        launches = read_launches(path=f"phase 22 {label} x {n_steps}")
        ev = c.events
        print(f"phase 22 {label} x {n_steps}: K8 launches {launches['toi_substep']}, "
              f"toi.substep_kernel {ev['toi.substep_kernel']}, toi.rounds {ev['toi.rounds']}, "
              f"host reads a step {c.host_syncs / c.steps:.3f}, reads in b2.toi_substep "
              f"{c.reads.get('b2.toi_substep', 0)}")
        if not calls:
            raise AssertionError(f"{label}: no TOI sub-step in {n_steps} steps")
        if launches["toi_substep"] != ev["toi.substep_kernel"] or \
                launches["toi_substep"] != len(calls):
            raise AssertionError(f"{label}: {launches['toi_substep']} K8 launches, "
                                 f"{len(calls)} sub-steps, {ev}")
        args, iterations = max(calls, key=lambda c: int(c[0][0].sum()))
        del calls, states
        got = ktoi.toi_substep_passes(*args, iterations=iterations)
        want = plain_passes(*args, iterations=iterations)
        sync(dev)
        for x, y, name in zip(got, want, ("pose", "vel", "impulses", "nb_impulses",
                                          "nb_vel")):
            if not torch.equal(x, y):
                raise AssertionError(f"{label}: K8 != the plain version in {name}")
        solved, kept = int(args[0].sum()), int((args[8] >= 0).sum())
        print(f"phase 22 {label}, the busiest sub-step: {args[0].numel()} lanes, {solved} "
              f"solved, {kept} kept neighbors, K8 == plain in all five outputs")
        m = measure(lambda *a: ktoi.toi_substep_passes(*a, iterations=iterations), args)
        plain = time_call(lambda *a: plain_passes(*a, iterations=iterations), args, reps=3)
        n_bytes = substep_bytes(args)
        bnd = least_ms(n_bytes)
        print(f"phase 22 K8 [{label}]: {show(m, n_bytes)}; plain {plain:.3f} ms (events "
              f"around eager calls); bound {bnd[0]:.5f} ms ({bnd[1]}, {n_bytes / 1e6:.3f} "
              f"MB), {100 * bnd[0] / m['ms']:.2f}% of it")
        results[label] = (m, plain, bnd, None)
        del args, got, want
        torch.cuda.empty_cache()
    keep_worst("toi_substep", 0.0)
    TIMES["toi_substep"] = results["16 x multithread_demo(2800)"]


def healthy(states, ev):
    if int(ev.color_overflow.max()) != 0 or int(ev.toi_overflow.max()) != 0:
        raise AssertionError("color or TOI overflow on the main path")


def main_path(dev):
    """Phase 4: 512 x pyramid(10) x 60; K1 and K2 held to their plain
    versions on the inputs it recorded, which phase 8 times."""
    import torch
    rec = Recorder()
    torch.cuda.synchronize()
    zero_launches()
    states, syncs = roll(batch(10, 512, dev), 60, check=healthy, middle=rec.solve_middle,
                         toi=rec.time_of_impact)
    torch.cuda.synchronize()
    launches = read_launches(path="512 x pyramid(10) x 60")
    b = states.bodies
    if min(launches[k] for k in ("solve_middle", "toi", "color_walk")) <= 0:
        raise AssertionError(f"the main path did not launch every kernel: {launches}")
    if not all(bool(torch.isfinite(t).all()) for t in (b.c, b.a, b.v, b.w)):
        raise AssertionError("NaN/inf in the body state")
    min_y = float(b.c[..., 1][b.body_type == 2].min())
    if min_y <= 0.4:
        raise AssertionError(f"a box fell through: min center y {min_y}")
    print(f"phase 4 main path 512 x pyramid(10) x 60 steps, continuous=True: "
          f"launches={launches}, host syncs/step={syncs / 60:.2f}, min box y={min_y:.4f}, "
          f"touching/world={float(states.contacts.touching.sum(1).float().mean()):.1f}")
    # K1's inputs of the last step, K2's of the round with most touching lanes
    INPUTS["main"] = rec.middle, rec.busiest_toi()
    compare_middle(rec.middle, "512 x pyramid(10), main path, last step", phase=4)
    compare_toi(INPUTS["main"][1], "512 x pyramid(10), main path, busiest round", phase=4)


def kernel_vs_plain_path(dev):
    """Phase 5: the whole step through the kernels vs the plain versions."""
    import torch
    from box2d_mt_tpu_torch.ops import solve_middle as sm
    from box2d_mt_tpu_torch.ops import toi as ktoi
    ker, _ = roll(batch(10, 64, dev), 20)
    pln, _ = roll(batch(10, 64, dev), 20, middle=sm.solve_middle_plain,
                  toi=ktoi.time_of_impact_lanes_plain)
    d = {k: (getattr(ker.bodies, k) - getattr(pln.bodies, k)).abs().max().item()
         for k in ("c", "a", "v")}
    awake_eq = bool(torch.equal(ker.bodies.awake, pln.bodies.awake))
    toi_eq = bool(torch.equal(ker.contacts.toi_count, pln.contacts.toi_count))
    print(f"phase 5 kernel vs plain path, 64 x pyramid(10) x 20 steps: "
          f"max|dc|={d['c']:.3g} max|da|={d['a']:.3g} max|dv|={d['v']:.3g} "
          f"awake_equal={awake_eq} toi_count_equal={toi_eq}")
    if d["c"] > 2e-5 or d["a"] > 2e-5 or d["v"] > 1e-4 or not (awake_eq and toi_eq):
        raise AssertionError(f"kernel path and plain path disagree: {d}")


def large_pyramids(dev):
    """Phase 6: 128 x pyramid(44) x 20; K1 and K2 held to their plain
    versions on the inputs it recorded."""
    import torch
    rec = Recorder()
    torch.cuda.synchronize()
    zero_launches()
    big, syncs = roll(batch(44, 128, dev), 20, check=healthy, middle=rec.solve_middle,
                      toi=rec.time_of_impact)
    torch.cuda.synchronize()
    launches = read_launches(path="128 x pyramid(44) x 20")
    if not bool(torch.isfinite(big.bodies.c).all()):
        raise AssertionError("NaN/inf in the pyramid(44) body state")
    print(f"phase 6 128 x pyramid(44) x 20 steps: host syncs/step={syncs / 20:.2f}, "
          f"launches={launches}")
    if min(launches["solve_middle"], launches["toi"]) <= 0:
        raise AssertionError(f"pyramid(44) did not launch K1 and K2: {launches}")
    compare_middle(rec.middle, "128 x pyramid(44), last step", phase=6)
    compare_toi(rec.busiest_toi(), "128 x pyramid(44), busiest round", phase=6)


def sleep(dev):
    """Phase 7: a pyramid until every body sleeps, then the all-asleep skip."""
    import torch
    from box2d_mt_tpu_torch.world import step_batched
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
    print(f"phase 7 sleep: every body asleep after {slept_at} steps; "
          f"all-asleep skip taken={skipped} (host syncs {ev.host_syncs})")
    if not skipped:
        raise AssertionError("the all-asleep skip was not taken")


def kernel_times(dev):
    """Phase 8: K1's and K2's times per call and bounds, at the main path's
    recorded inputs (phase 4) and at the other shapes of the module's
    docstring."""
    import torch
    from box2d_mt_tpu_torch.ops import solve_middle as sm
    from box2d_mt_tpu_torch.ops import toi as ktoi
    args_main, lanes_main = INPUTS["main"]
    floor = launch_floor()
    print(f"phase 8 launch floor (an empty kernel of one warp): {show(floor)}")
    k1_m = measure(sm.solve_middle, args_main)
    k1_plain = time_call(sm.solve_middle_plain, args_main, reps=3)
    n_bytes, k1_bnd = k1_bound(args_main)
    print(f"phase 8 solve_middle [512 x pyramid(10)]: {show(k1_m, n_bytes)}; "
          f"plain {k1_plain:.4f} ms per call; {middle_path(args_main)}")
    for label, args in (
            ("64 x pyramid(10)", capture_middle(roll(batch(10, 64, dev), 30)[0])),
            ("16 x pyramid(44)", capture_middle(roll(batch(44, 16, dev), 60)[0])),
            ("4096 x pyramid(10), the main path's inputs x 8",
             tuple(torch.cat([a] * 8).contiguous() if torch.is_tensor(a) else a
                   for a in args_main))):
        print(f"phase 8 solve_middle [{label}]: "
              f"{show(measure(sm.solve_middle, args, profiler=False), k1_bound(args)[0])}; "
              f"{middle_path(args)}")
    # what K1's time is made of: the same call without sweeps (pack,
    # integrate, unpack, launch), with the velocity sweeps alone and with
    # the position sweeps alone
    split = {vp: device_time(sm.solve_middle, (*args_main[:8], *vp))
             for vp in ((0, 0), (MAIN["velocity_iterations"], 0),
                        (0, MAIN["position_iterations"]))}
    print("phase 8 solve_middle [512 x pyramid(10)] split, device ms by (velocity, "
          "position) iterations: " + ", ".join(f"{k}: {v:.4f}" for k, v in split.items()))
    print(f"phase 8 bounds: solve_middle {k1_bnd[0]:.5f} ms ({k1_bnd[1]}: {n_bytes} B, "
          f"{int(args_main[2][:, -1].sum())} solved lanes; device time at "
          f"{100 * k1_bnd[0] / k1_m['ms']:.2f}% of it)")
    TIMES["solve_middle"] = (k1_m, k1_plain, k1_bnd, None)
    # K2 at three shapes (its grid beside each) and on the main path's
    # round with only its costliest lane active: how much of K2 is one
    # lane's dependent chain
    lanes_4096 = capture_toi(batch(10, 4096, dev), 30)
    compare_toi(lanes_4096, "4096 x pyramid(10), first touching round", phase=8)
    for key, label, lanes in (
            ("main", "512 x pyramid(10), main path's busiest round", lanes_main),
            ("fast", "4096 fast boxes vs a thin wall",
             capture_toi(fast_box_worlds(4096, dev), 1)),
            ("4096", "4096 x pyramid(10), first touching round", lanes_4096),
            ("chain", "chain floor: the main path's busiest round, only its costliest "
                      "lane active", costliest_lane(lanes_main))):
        k2 = time_toi(lanes, label, phase=8)
        blocks, span = ktoi.grid(k2["lanes"])
        print(f"  grid: {blocks} blocks of 384 threads, {span} lanes a block "
              f"({ktoi.grid(1 << 30)[0]} resident at once)")
        if key == "main":
            TIMES["toi"] = (k2, k2["plain_ms"], k2["bound"], None)


def joint_worlds(dev):
    """Phase 10: the sandwich's main path on the tumbler and the chain; the
    inputs of their busiest steps are phase 12's."""
    import torch

    def boxes_inside(states):
        b = states.bodies                            # slots 0, 1: ground, container
        d = b.c[:, 2:202] - b.c[:, 1:2]
        sn, cs_ = torch.sin(b.a[:, 1:2]), torch.cos(b.a[:, 1:2])
        local = torch.stack([cs_ * d[..., 0] + sn * d[..., 1],
                             -sn * d[..., 0] + cs_ * d[..., 1]], -1)
        far = float(local.abs().max())
        if not far < 10.5:
            raise AssertionError(f"a tumbler box left the container: {far}")

    def planks_above(states):
        low = float(states.bodies.c[:, 1:31, 1].min())
        if not low > -0.2:
            raise AssertionError(f"a chain plank fell through the ground: y {low}")

    _, rec_t = run_joint_scene("tumbler", 200, 256, 120, dev, boxes_inside, phase=10)
    first_t = compare_sandwich(rec_t.busiest(), "256 x tumbler(200), busiest step", phase=10)
    del rec_t
    launches_c, rec_c = run_joint_scene("chain_links", 30, 512, 180, dev, planks_above,
                                        phase=10)
    first_c = compare_sandwich(rec_c.busiest(), "512 x chain_links(30), busiest step",
                               phase=10)
    del rec_c
    # the tumbler has no TOI candidate (every pair is dynamic-dynamic), so
    # of the joint scenes only the chain runs K2 as well
    if min(launches_c[k] for k in SANDWICH_NAMES + ("toi",)) <= 0:
        raise AssertionError(f"the chain's path missed a kernel: {launches_c}")
    INPUTS["sandwich"] = first_t, first_c


def joint_kernel_vs_plain_path(dev):
    """Phase 11: the whole step of a joint world through the kernels vs
    the plain versions."""
    import torch
    from box2d_mt_tpu_torch.ops import solve_middle as sm
    from box2d_mt_tpu_torch.ops import toi as ktoi
    ker, _ = roll(joint_batch("tumbler", 200, 32, dev), 20)
    pln, _ = roll(joint_batch("tumbler", 200, 32, dev), 20, middle=sm.solve_middle_plain,
                  toi=ktoi.time_of_impact_lanes_plain, sandwich=sm.SANDWICH_PLAIN)
    d = {k: (getattr(ker.bodies, k) - getattr(pln.bodies, k)).abs().max().item()
         for k in ("c", "a", "v")}
    kr, pr = ker.joints.revolute, pln.joints.revolute
    d["joint impulse"] = max((kr.impulse - pr.impulse).abs().max().item(),
                             (kr.motor_impulse - pr.motor_impulse).abs().max().item())
    awake_eq = bool(torch.equal(ker.bodies.awake, pln.bodies.awake))
    print(f"phase 11 kernel vs plain path, 32 x tumbler(200) x 20 steps: "
          + " ".join(f"max|d {k}|={v:.3g}" for k, v in d.items())
          + f" awake_equal={awake_eq} touching/world="
          f"{float(ker.contacts.touching.sum(1).float().mean()):.1f}")
    if (d["c"] > 2e-5 or d["a"] > 2e-5 or d["v"] > 1e-4 or d["joint impulse"] > 1e-4
            or not awake_eq):
        raise AssertionError(f"joint world: kernel path and plain path disagree: {d}")


def sandwich_times(dev):
    """Phase 12: K3-K6's times per call and bounds at the tumbler's busiest
    step, K4's and K5's also at the chain's (phase 10's inputs)."""
    from benchmark import roofline
    from box2d_mt_tpu_torch.ops import solve_middle as sm
    first_t, first_c = INPUTS["sandwich"]
    floor = launch_floor()
    sw_bytes, solved_t, k3_words = sandwich_bytes(first_t)
    sw_ops = {"pack_packed": 0, "vel_iter_packed": solved_t * roofline.K1_OPS_VEL,
              "pos_iter_packed": solved_t * roofline.K1_OPS_POS, "unpack_packed": 0}
    lib = library_calls(first_t)
    for name, fn, plain in zip(SANDWICH_NAMES, sm.SANDWICH, sm.SANDWICH_PLAIN):
        # a sweep updates its table in place: repeated calls move the
        # impulses on, which changes no trip count and no byte moved
        TIMES[name] = m, plain_ms, bnd, lib_ms = (
            measure(fn, first_t[name]), time_call(plain, first_t[name], reps=3),
            least_ms(sw_bytes[name], sw_ops[name]),
            device_time(*lib[name]) if name in lib else None)
        print(f"phase 12 {name} [256 x tumbler(200), {solved_t} solved lanes]: "
              f"{show(m, sw_bytes[name])}; "
              f"plain {plain_ms:.4f} ms per call; bound {bnd[0]:.5f} ms "
              f"({bnd[1]}: {sw_bytes[name]} B; device time at {100 * bnd[0] / m['ms']:.2f}% "
              f"of it, {m['ms'] / floor['ms']:.2f} x the launch floor); library call "
              f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms on the device'}")
        if name == "pack_packed":
            words = least_ms(k3_words)
            print(f"phase 12 pack_packed bound in 32-byte sectors {bnd[0]:.5f} ms "
                  f"({sw_bytes[name]} B, device time at {100 * bnd[0] / m['ms']:.2f}%); "
                  f"in 4-byte words {words[0]:.5f} ms ({k3_words} B, "
                  f"{100 * words[0] / m['ms']:.2f}%)")
    sw_bytes_c, solved_c, _ = sandwich_bytes(first_c)
    for name in ("vel_iter_packed", "pos_iter_packed"):
        fn, plain = getattr(sm, name), getattr(sm, name + "_plain")
        m = measure(fn, first_c[name], profiler=False)
        bnd = least_ms(sw_bytes_c[name], solved_c * (
            roofline.K1_OPS_VEL if name[0] == "v" else roofline.K1_OPS_POS))
        print(f"phase 12 {name} [512 x chain_links(30), busiest step, {solved_c} solved "
              f"lanes; {sweep_path(first_c[name])}]: {show(m, sw_bytes_c[name])}; "
              f"plain {time_call(plain, first_c[name], reps=3):.4f} ms per call; bound "
              f"{bnd[0]:.5f} ms ({bnd[1]}; device time at {100 * bnd[0] / m['ms']:.2f}% of "
              f"it, {m['ms'] / floor['ms']:.2f} x the launch floor)")


def circles_chains_sensors(dev):
    """Phase 14."""
    circle_stack(dev)
    pinball_table(dev)
    zoo_goldens(dev)


def car_and_joint_types(dev):
    """Phase 15."""
    car_path(dev)
    joint_types(dev)


# the phases by number (phases 18 and 19 run together in one pool of
# workers: checks_in_parallel), and the phase whose recorded inputs a
# phase times, which runs before it
PHASES = {4: main_path, 5: kernel_vs_plain_path, 6: large_pyramids, 7: sleep,
          8: kernel_times, 10: joint_worlds, 11: joint_kernel_vs_plain_path,
          12: sandwich_times, 13: ccd_goldens, 14: circles_chains_sensors,
          15: car_and_joint_types, 16: large_worlds, 17: hooks_and_mutations,
          18: checks_in_parallel, 19: checks_in_parallel, 20: sharded_path,
          21: coloring_kernel, 22: substep_kernel}
TIMES_INPUTS_OF = {8: 4, 12: 10}


def main() -> int:
    import argparse
    import torch
    ap = argparse.ArgumentParser(description="Smoke run of the port on one GPU.")
    ap.add_argument("--phase", type=int, nargs="+", choices=sorted(PHASES), metavar="N",
                    help="the build and these phases alone (and the phases whose inputs "
                         "they time); every phase when left out")
    chosen = ap.parse_args().phase or list(PHASES)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs a GPU",
              file=sys.stderr)
        return 2
    from box2d_mt_tpu_torch import cuda_build

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}  (torch {torch.__version__}, cuda {torch.version.cuda})")
    t_start = time.perf_counter()

    def lap(phase):
        print(f"  [phase {phase} done at {time.perf_counter() - t_start:.1f} s]")

    # ---- 1. build, one nvcc per source
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        builds = dict(zip(SOURCES, pool.map(cuda_build.build, SOURCES)))
    print(f"phase 1 build: {time.perf_counter() - t0:.2f} s wall")
    for name, info in builds.items():
        print(f"  {name}: nvcc {info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "entry function" in line:
                print("    ptxas:", line.strip())
    lap(1)

    selected = sorted(set(chosen) | {TIMES_INPUTS_OF[n] for n in chosen
                                     if n in TIMES_INPUTS_OF})
    pooled = tuple(str(n) for n in (18, 19) if n in selected)
    for n in selected:
        if n not in (18, 19):
            PHASES[n](dev)
            lap(n)
        elif str(n) == pooled[0]:
            checks_in_parallel(dev, pooled)
            lap("-".join(pooled))
    print(f"smoke run {time.perf_counter() - t_start:.1f} s")

    record = []
    for name, (m, plain, bnd, lib_ms) in TIMES.items():
        by_path = {p: n[name] for p, n in PATHS.items() if n.get(name)}
        record.append(dict(name=name, **KERNELS[name], launches=sum(by_path.values()),
                           launches_by_path=by_path, max_abs_err=WORST.get(name),
                           ms=m["ms"], host_ms=m["host_ms"], plain_ms=plain,
                           bound_ms=bnd[0], bound_by=bnd[1], library_ms=lib_ms))
    print(f"card: {card}")
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
