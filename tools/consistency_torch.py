#!/usr/bin/env python3
"""Per-scene consistency harness of the PyTorch port (box2d_mt_tpu_torch),
the counterpart of tools/consistency.py and of the reference's TestMT.cpp
(Testbed/Framework/TestMT.cpp:50-231): every scene of that tool's list,
built with the port's models/scenes.py, plus a bullet scene and a
mutation sequence, is rolled with continuous collision and checked for

  * run-to-run bit equality: two rolls of the same start state, every
    State leaf equal (torch.equal);
  * cross-lane bit equality: `--lanes` replicas of one world in one batch,
    every leaf of every lane equal to lane 0's;
  * no NaN in the bodies' positions and velocities.

It writes one CSV row per scene: name, bodies, steps, lanes, pass/fail per
check, worlds*steps/s of the second roll and the wall time.

    python3 tools/consistency_torch.py [--steps N] [--lanes L]
        [--device cuda|cpu] [--out FILE.csv]

The device defaults to the card. The exit code is 1 when a check fails.
`run_batch` rolls several scenes as one padded batch, with the same
checks for each; chip_smoke.py's phase 19 runs the list that way, in the
groups of `batch_groups`.
"""

import argparse
import csv
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

DT = 1.0 / 60.0
FIELDS = ("scene", "bodies", "steps", "lanes", "rerun_bitexact", "lanes_bitexact",
          "no_nan", "worlds_steps_per_s", "wall_s", "batch", "passed")
# the capacities (bodies, fixtures, contacts) a scene must fit to share a
# padded batch of that size; a larger scene rolls alone
SIZE_CLASSES = ((16, 32, 128), (64, 128, 512))


def bullet_wall(device="cuda", **capacity):
    """A stream of bullets against a thin wall: the TOI rounds' gating,
    where a world's result could come to depend on its batch."""
    from box2d_mt_tpu_torch import WorldBuilder, settings, shapes
    wb = WorldBuilder(gravity=(0.0, -10.0))
    ground = wb.create_body()
    wb.create_fixture(ground, shapes.Edge((-30.0, 0.0), (30.0, 0.0)))
    wall = wb.create_body(position=(10.0, 3.0))
    wb.create_fixture(wall, shapes.Polygon.box(0.05, 3.0))
    for i in range(6):
        b = wb.create_body(body_type=settings.DYNAMIC_BODY,
                           position=(-8.0 - 1.5 * i, 1.0 + 0.8 * i),
                           bullet=True, linear_velocity=(120.0, 0.0))
        wb.create_fixture(b, shapes.Circle(0.1), density=5.0, restitution=0.3)
    return wb.freeze(device=device, **capacity)


def scene_list(steps):
    """(name, builder(device, **capacity), steps): tools/consistency.py's
    scenes with the same arguments, and the bullet scene."""
    from box2d_mt_tpu_torch.models import scenes as s

    def arg(fn, *a, **k):
        return lambda device="cuda", **cap: fn(*a, device=device, **k, **cap)

    entries = [
        ("hello_world", s.hello_world), ("falling_circle", s.falling_circle),
        ("vertical_stack10", arg(s.vertical_stack, 10)), ("pyramid10", arg(s.pyramid, 10)),
        ("revolute_pendulum", s.revolute_pendulum),
        ("distance_pendulum", s.distance_pendulum), ("prismatic_slide", s.prismatic_slide),
        ("tumbler80", arg(s.tumbler, 80)), ("weld_pendulum", s.weld_pendulum),
        ("weld_soft", arg(s.weld_pendulum, soft=True)),
        ("friction_top_down", s.friction_top_down), ("rope_swing", s.rope_swing),
        ("motor_drive", s.motor_drive), ("wheel_car", s.wheel_car),
        ("gear_train", s.gear_train), ("pulley_pair", s.pulley_pair),
        ("multithread_demo200", arg(s.multithread_demo, 200)),
        ("many_bodies400", arg(s.many_bodies, 400, 2.5)), ("bullet_wall", bullet_wall),
        ("dominos", s.dominos), ("web", s.web), ("bridge", arg(s.bridge, 12)),
        ("cantilever", arg(s.cantilever, 4)), ("chain_links", arg(s.chain_links, 10)),
        ("sphere_stack", arg(s.sphere_stack, 5)), ("heavy_on_light", s.heavy_on_light),
        ("tiles", arg(s.tiles, 4, 20, 2)), ("conveyor_belt", s.conveyor_belt),
        ("one_sided_platform", s.one_sided_platform), ("slider_crank", s.slider_crank),
        ("add_pair", arg(s.add_pair, 60)), ("confined", arg(s.confined, 4, 3)),
        ("mobile", arg(s.mobile, 3)), ("body_types", s.body_types),
        ("varying_friction", s.varying_friction),
        ("varying_restitution", s.varying_restitution),
        ("compound_shapes", arg(s.compound_shapes, 4)), ("car", s.car),
        ("sensor_zone", s.sensor_zone), ("collision_filtering", s.collision_filtering),
        ("pinball", s.pinball), ("theo_jansen", s.theo_jansen), ("breakable", s.breakable),
        ("bullet_test", s.bullet_test), ("continuous_test", s.continuous_test),
        ("heavy_on_light_two", s.heavy_on_light_two),
        ("mobile_balanced", arg(s.mobile_balanced, 3)), ("apply_force", s.apply_force),
        ("edge_shapes", arg(s.edge_shapes, 8)), ("poly_shapes", arg(s.poly_shapes, 8)),
        ("character_collision", s.character_collision),
        ("chain_problem", s.chain_problem), ("edge_test", s.edge_test), ("skier", s.skier),
        ("collision_processing", arg(s.collision_processing, 7)),
        ("sleep_collide_perf", arg(s.sleep_collide_perf, 2, 6, 1, 20)),
        ("basic_slider_crank", s.basic_slider_crank), ("shape_editing", s.shape_editing),
    ]
    return [(name, build, steps) for name, build in entries]


def capacities(state) -> dict:
    """The freeze() capacities of a built state."""
    from box2d_mt_tpu_torch.joints import blocks
    return dict(body_capacity=state.bodies.c.shape[1],
                fixture_capacity=state.fixtures.body.shape[1],
                contact_capacity=state.contacts.capacity,
                joint_capacity={k: b.active.shape[1] for k, b in blocks(state.joints)})


def padded_batch(entries, device):
    """One batch of `lanes` copies of each (name, build, lanes) entry,
    every world frozen with the largest capacities among them. Returns
    (state, [(first world, lanes, bodies)])."""
    from box2d_mt_tpu_torch.state import concat_worlds, replicate
    built = [build(device=device) for _, build, _ in entries]
    if len(built) > 1:
        caps = [capacities(st) for st in built]
        top = {k: max(c[k] for c in caps)
               for k in ("body_capacity", "fixture_capacity", "contact_capacity")}
        top["joint_capacity"] = {}
        for c in caps:
            for k, n in c["joint_capacity"].items():
                top["joint_capacity"][k] = max(n, top["joint_capacity"].get(k, 0))
        built = [build(device=device, **top) for _, build, _ in entries]
    spans, first = [], 0
    for st, (_, _, lanes) in zip(built, entries):
        spans.append((first, lanes, int((st.bodies.body_type >= 0).sum())))
        first += lanes
    return concat_worlds([replicate(st, lanes) for st, (_, _, lanes) in
                          zip(built, entries)]), spans


def leaves(state):
    """Every State leaf, in map_leaves order."""
    from box2d_mt_tpu_torch.state import map_leaves
    out = []
    map_leaves(lambda t: out.append(t) or t, state)
    return out


def roll(state, steps, kinds, on_step=None, **kw):
    """`steps` steps in inference mode: the same values, with autograd's
    dispatch skipped on the host. `on_step(state, events)` sees each."""
    from box2d_mt_tpu_torch.world import step_batched
    with torch.inference_mode():
        for _ in range(steps):
            state, ev = step_batched(state, DT, kinds=kinds, **kw)
            if on_step is not None:
                on_step(state, ev)
    return state


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_batch(entries, steps, device="cuda", on_step=None, longer=0, **step_kw):
    """Roll `entries` ((name, build, lanes) each) as one padded batch twice
    from the same start and check every entry: run to run (every leaf
    after `steps` steps), lane to lane (there and at the end of the first
    roll) and no NaN. The first roll goes on for `longer` more steps, and
    `on_step(state, events)` sees each of its steps. Returns one CSV row
    (dict) per entry; worlds_steps_per_s is the whole batch's, from the
    second roll."""
    from box2d_mt_tpu_torch.world import possible_kinds
    start, spans = padded_batch(entries, device)
    kinds = possible_kinds(start)
    t0 = time.perf_counter()
    first = roll(start, steps, kinds, on_step, **step_kw)
    last = roll(first, longer, kinds, on_step, **step_kw)
    _sync(device)
    t1 = time.perf_counter()
    second = roll(start, steps, kinds, **step_kw)
    _sync(device)
    t2 = time.perf_counter()
    a, b, z = leaves(first), leaves(second), leaves(last)
    rows = []
    for (name, _, lanes), (w0, n, bodies) in zip(entries, spans):
        span = slice(w0, w0 + n)
        rerun = all(torch.equal(x[span], y[span]) for x, y in zip(a, b))
        lanes_ok = all(torch.equal(x[w0 + k], x[w0]) for x in a + z for k in range(1, n))
        body = last.bodies
        no_nan = bool(torch.isfinite(body.c[span]).all() and torch.isfinite(body.v[span]).all())
        rows.append(dict(scene=name, bodies=bodies, steps=steps, lanes=lanes,
                         rerun_bitexact=rerun, lanes_bitexact=lanes_ok, no_nan=no_nan,
                         worlds_steps_per_s=round(first.n_worlds * steps / (t2 - t1), 1),
                         wall_s=round(t2 - t0, 2),
                         batch="+".join(e[0] for e in entries) if len(entries) > 1 else "",
                         passed=rerun and lanes_ok and no_nan))
    return rows


def run_scene(build, steps, lanes=4, device="cuda", name="scene", **step_kw):
    """run_batch for one scene alone: its CSV row."""
    return run_batch([(name, build, lanes)], steps, device, **step_kw)[0]


def mutation_sequence(steps=40, lanes=4, device="cuda"):
    """Spawn a body with a circle at step 10 and strike body 1 at step 20
    of a pyramid(4) batch, between steps (tools/consistency.py's
    sequence). Returns the positions of every step, (steps, lanes, body
    slots, 2), and the bodies in each world at the end."""
    from box2d_mt_tpu_torch import mutate, settings, shapes
    from box2d_mt_tpu_torch.models import scenes
    from box2d_mt_tpu_torch.state import replicate
    from box2d_mt_tpu_torch.world import step_batched
    st = replicate(scenes.pyramid(4, device=device, body_capacity=16, fixture_capacity=16),
                   lanes)
    out = []
    with torch.inference_mode():
        for i in range(steps):
            if i == 10:
                st, b = mutate.add_body(st, body_type=settings.DYNAMIC_BODY,
                                        position=(3.0, 6.0))
                st, _ = mutate.add_fixture(st, b, shapes.Circle(0.4), density=2.0)
            if i == 20:
                st = mutate.apply_linear_impulse(st, 1, (2.0, 3.0), (0.0, 0.0))
            st, _ = step_batched(st, DT)
            out.append(st.bodies.c.clone())
    return torch.stack(out), int((st.bodies.body_type[0] >= 0).sum())


def run_mutation_sequence(steps=40, lanes=4, device="cuda"):
    """The mutation sequence's CSV row: replayed twice, and its lanes."""
    t0 = time.perf_counter()
    one, bodies = mutation_sequence(steps, lanes, device)
    two, _ = mutation_sequence(steps, lanes, device)
    _sync(device)
    rerun = torch.equal(one, two)
    lanes_ok = all(torch.equal(one[:, k], one[:, 0]) for k in range(1, lanes))
    no_nan = bool(torch.isfinite(one).all())
    return dict(scene="mutation_sequence", bodies=bodies, steps=steps,
                lanes=lanes, rerun_bitexact=rerun, lanes_bitexact=lanes_ok, no_nan=no_nan,
                worlds_steps_per_s="", wall_s=round(time.perf_counter() - t0, 2), batch="",
                passed=rerun and lanes_ok and no_nan)


def batch_groups(entries, device="cuda"):
    """`entries` ((name, build, lanes) each) in groups that roll well as
    one padded batch. A step costs about what the union of its worlds'
    paths launches: the TOI rounds of the busiest world, and for each
    joint type its passes over the colors its joints use. So scenes share
    a batch by the first of SIZE_CLASSES they fit, by whether they have
    bullets and by whether they have joints; a larger scene rolls
    alone."""
    from box2d_mt_tpu_torch.joints import joints_present
    groups, alone = {}, []
    for entry in entries:
        st = entry[1](device=device)
        c = capacities(st)
        size = (c["body_capacity"], c["fixture_capacity"], c["contact_capacity"])
        fit = [k for k, cls in enumerate(SIZE_CLASSES)
               if all(x <= y for x, y in zip(size, cls))]
        if not fit:
            alone.append([entry])
        else:
            key = (fit[0], bool(st.bodies.bullet.any()), joints_present(st.joints))
            groups.setdefault(key, []).append(entry)
    return [groups[k] for k in sorted(groups)] + alone


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="consistency_torch.csv")
    args = ap.parse_args()
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("consistency_torch: no CUDA device (use --device cpu)", file=sys.stderr)
        return 2
    rows = []
    with open(args.out, "w", newline="") as f:
        out = csv.DictWriter(f, fieldnames=FIELDS)
        out.writeheader()

        def emit(row):
            rows.append(row)
            out.writerow(row)
            f.flush()
            print(",".join(str(row[k]) for k in FIELDS), flush=True)

        for name, build, steps in scene_list(args.steps):
            emit(run_scene(build, steps, args.lanes, args.device, name))
        emit(run_mutation_sequence(lanes=args.lanes, device=args.device))
    failed = [r["scene"] for r in rows if not r["passed"]]
    print(f"{len(rows)} scenes, {len(failed)} failed {failed} -> {args.out}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
