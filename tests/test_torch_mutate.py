"""The port's `mutate` against the JAX package's.

  * every public function of `box2d_mt_tpu.mutate`, applied to the same
    small world (ground, boxes, a circle, a revolute and a prismatic joint,
    spare slots of every joint type) by both packages: every leaf of the
    result equal, exactly; the leaves that pass through a mass reset or a
    sine/cosine (mass data, centers, velocities, fat AABBs, joint frames)
    within 1e-6;
  * the batched form: two worlds whose first free slots differ, indices
    as (W,) tensors with -1 for "leave this world as it is", each world
    equal to the one-world call;
  * the four goldens of Box2D's C++ engine that mutate between steps, as
    one padded batch of four worlds: shape_editing (a circle fixture added,
    made a sensor and removed), breakable (split on a PostSolve impulse
    above 40), collision_processing (the lighter body of each touching
    pair destroyed) and skier (teleported by set_transform), at the JAX
    package's bounds (tests/test_golden_interactive.py,
    tests/test_golden_zoo.py:321-335): 0.05, 0.1, 0.2, 0.02 (0.005 on
    skier's last step).

breakable: the port reads the PostSolve impulse of the TOI sub-steps too
(Events.toi_normal_impulse; the reference's b2Island::SolveTOI reports
it), so the break lands on step 167, as in the trace. The JAX package
reports no TOI impulse and misses the break. After the break the trace is
a tumble that the colored solver follows within 0.6 (the JAX package
rolled with the same break at step 167 gives the same figure), so the
trace's bound holds up to the break (steps 0-166) and the port is held to
the JAX package's roll with the same break after it.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from box2d_mt_tpu import mutate as jmutate
from box2d_mt_tpu import settings as jsettings
from box2d_mt_tpu import shapes as jshapes
from box2d_mt_tpu import world as jworld
from box2d_mt_tpu.models import scenes as jscenes
from box2d_mt_tpu_torch import mutate, settings, shapes, world
from box2d_mt_tpu_torch.models import scenes
from box2d_mt_tpu_torch.state import JOINT_BLOCKS, concat_worlds, map_leaves, to_numpy

from conftest import GOLDEN

_ALL_JOINTS = {name: 2 for name, _ in JOINT_BLOCKS}
# leaves a mass reset or a sine/cosine enters: held to 1e-6
_NEAR = {"bodies.inv_mass", "bodies.inv_inertia", "bodies.local_center", "bodies.c",
         "bodies.c0", "bodies.v", "bodies.w", "fixtures.aabb_lo", "fixtures.aabb_hi"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _build(pkg_world, pkg_shapes, pkg_settings, **freeze_kw):
    """Ground edge, two boxes, a circle and a rotated box; a revolute and a
    prismatic joint (for the gear); spare slots of every kind."""
    wb = pkg_world.WorldBuilder(gravity=(0.0, -10.0))
    g = wb.create_body()
    wb.create_fixture(g, pkg_shapes.Edge((-20.0, 0.0), (20.0, 0.0)))
    dyn = pkg_settings.DYNAMIC_BODY
    b1 = wb.create_body(body_type=dyn, position=(0.0, 0.5))
    wb.create_fixture(b1, pkg_shapes.Polygon.box(0.5, 0.5), density=1.0)
    b2 = wb.create_body(body_type=dyn, position=(3.0, 0.45), angle=0.3)
    wb.create_fixture(b2, pkg_shapes.Polygon.box(1.0, 0.4), density=2.0)
    b3 = wb.create_body(body_type=dyn, position=(-3.0, 0.5))
    wb.create_fixture(b3, pkg_shapes.Circle(0.5), density=1.5)
    b4 = wb.create_body(body_type=dyn, position=(0.0, 3.0), angular_velocity=0.5)
    wb.create_fixture(b4, pkg_shapes.Polygon.box(0.3, 0.6), density=1.0)
    wb.create_revolute_joint(g, b4, (0.0, 3.5))
    wb.create_prismatic_joint(g, b2, (3.0, 0.45), (1.0, 0.0))
    return wb.freeze(body_capacity=8, fixture_capacity=8, contact_capacity=64,
                     joint_capacity=_ALL_JOINTS, **freeze_kw)


@pytest.fixture(scope="module")
def base():
    jst = _build(jworld, jshapes, jsettings)
    tst = _build(world, shapes, settings, device="cpu")
    return jst, tst


def _leaves(st):
    for group in ("bodies", "fixtures", "contacts"):
        for f in dataclasses.fields(getattr(st, group)):
            yield f"{group}.{f.name}", getattr(getattr(st, group), f.name)
    for name, _ in JOINT_BLOCKS:
        blk = getattr(st.joints, name)
        for f in dataclasses.fields(blk):
            yield f"joints.{name}.{f.name}", getattr(blk, f.name)
    for k in ("gravity", "inv_dt0", "pairs_dirty"):
        yield k, getattr(st, k)


def _assert_same(jst, tst):
    got = dict(_leaves(to_numpy(tst)))
    for name, ref in _leaves(jax.tree.map(np.asarray, jst)):
        mine = got[name][0]
        assert mine.shape == ref.shape and mine.dtype == ref.dtype, name
        if np.array_equal(mine, ref):
            continue
        near = name in _NEAR or name.startswith("joints.") and mine.dtype == np.float32
        assert near, f"{name}: {mine} != {ref}"
        with np.errstate(invalid="ignore"):
            ok = (mine == ref) | (np.abs(mine - ref) <= 1e-6 * np.maximum(1.0, np.abs(ref)))
        assert ok.all(), f"{name}: max |d| {np.nanmax(np.abs(mine - ref))}"


# each case: fn(mutate module, shapes module, settings module, state) ->
# state or (state, index), run by both packages
_CASES = {
    "set_transform": lambda m, s, k, st: m.set_transform(st, 2, (1.0, 2.0), 0.7),
    "set_linear_velocity": lambda m, s, k, st: m.set_linear_velocity(st, 1, (1.5, -2.0)),
    "set_angular_velocity": lambda m, s, k, st: m.set_angular_velocity(st, 3, 2.5),
    "apply_force": lambda m, s, k, st: m.apply_force(st, 2, (3.0, 4.0), (3.5, 0.2)),
    "apply_force_center": lambda m, s, k, st: m.apply_force(st, 1, (3.0, 4.0), wake=False),
    "apply_torque": lambda m, s, k, st: m.apply_torque(st, 1, 7.0),
    "apply_linear_impulse": lambda m, s, k, st: m.apply_linear_impulse(
        st, 2, (0.5, 1.0), (2.5, 0.8)),
    "apply_angular_impulse": lambda m, s, k, st: m.apply_angular_impulse(st, 2, 0.75),
    "set_type_static": lambda m, s, k, st: m.set_type(st, 2, k.STATIC_BODY),
    "set_type_kinematic": lambda m, s, k, st: m.set_type(st, 3, k.KINEMATIC_BODY),
    "set_bullet": lambda m, s, k, st: m.set_bullet(st, 1, True),
    "set_enabled": lambda m, s, k, st: m.set_enabled(st, 3, False),
    "set_fixed_rotation": lambda m, s, k, st: m.set_fixed_rotation(st, 2, True),
    "set_linear_damping": lambda m, s, k, st: m.set_linear_damping(st, 1, 0.3),
    "set_angular_damping": lambda m, s, k, st: m.set_angular_damping(st, 1, 0.4),
    "set_gravity_scale": lambda m, s, k, st: m.set_gravity_scale(st, 1, 0.5),
    "set_friction": lambda m, s, k, st: m.set_friction(st, 1, 0.9),
    "set_restitution": lambda m, s, k, st: m.set_restitution(st, 3, 0.6),
    "set_density": lambda m, s, k, st: m.set_density(st, 2, 3.5),
    "set_contact_tangent_speed": lambda m, s, k, st: m.set_contact_tangent_speed(
        st, 0, 1, 5.0),
    "set_contact_friction": lambda m, s, k, st: m.set_contact_friction(st, 1, 0, 0.1),
    "set_contact_restitution": lambda m, s, k, st: m.set_contact_restitution(
        m.set_contact_restitution(st, 0, 3, 0.4), 0, 3),
    "set_sensor": lambda m, s, k, st: m.set_sensor(st, 3, True),
    "set_thick_shape": lambda m, s, k, st: m.set_thick_shape(st, 2, True),
    "set_filter": lambda m, s, k, st: m.set_filter(st, 2, category=2, mask=0xFFFD, group=-1),
    "add_body": lambda m, s, k, st: m.add_body(
        st, body_type=k.DYNAMIC_BODY, position=(5.0, 6.0), angle=0.2,
        linear_velocity=(1.0, 0.0), angular_velocity=0.3, linear_damping=0.1,
        bullet=True, gravity_scale=0.5),
    "add_fixture_polygon": lambda m, s, k, st: m.add_fixture(
        st, 1, s.Polygon.box(0.25, 0.5, (0.5, 0.25), 0.3), density=2.0, friction=0.4,
        restitution=0.1, filter_group=3),
    "add_fixture_circle": lambda m, s, k, st: m.add_fixture(
        st, 2, s.Circle(0.3, (0.5, -0.2)), density=4.0, is_sensor=True),
    "add_fixture_edge": lambda m, s, k, st: m.add_fixture(
        st, 0, s.Edge((-5.0, 1.0), (5.0, 1.0), v0=(-6.0, 0.0), v3=(6.0, 0.0))),
    "remove_fixture": lambda m, s, k, st: m.remove_fixture(st, 2),
    "remove_body": lambda m, s, k, st: m.remove_body(st, 4),
    "add_revolute_joint": lambda m, s, k, st: m.add_revolute_joint(
        st, 1, 2, (1.5, 0.5), enable_limit=True, lower_angle=-0.5, upper_angle=0.5,
        enable_motor=True, motor_speed=1.0, max_motor_torque=10.0),
    "add_distance_joint": lambda m, s, k, st: m.add_distance_joint(
        st, 1, 3, (0.0, 0.5), (-3.0, 0.5), frequency=2.0, damping_ratio=0.3),
    "add_prismatic_joint": lambda m, s, k, st: m.add_prismatic_joint(
        st, 0, 3, (-3.0, 0.5), (0.6, 0.8), enable_limit=True, lower_translation=-1.0,
        upper_translation=1.0),
    "add_weld_joint": lambda m, s, k, st: m.add_weld_joint(st, 1, 2, (1.5, 0.5),
                                                          frequency=3.0),
    "add_friction_joint": lambda m, s, k, st: m.add_friction_joint(
        st, 0, 1, (0.0, 0.5), max_force=2.0, max_torque=1.0),
    "add_rope_joint": lambda m, s, k, st: m.add_rope_joint(
        st, 1, 3, (0.1, 0.2), (0.0, 0.0), 4.0),
    "add_motor_joint": lambda m, s, k, st: m.add_motor_joint(st, 0, 2, max_force=50.0),
    "add_mouse_joint": lambda m, s, k, st: m.add_mouse_joint(
        m.set_awake(st, 1, False), 1, (0.2, 0.9), max_force=100.0),
    "add_wheel_joint": lambda m, s, k, st: m.add_wheel_joint(
        st, 1, 3, (-3.0, 0.5), (0.0, 1.0), enable_motor=True, motor_speed=2.0,
        max_motor_torque=5.0),
    "add_pulley_joint": lambda m, s, k, st: m.add_pulley_joint(
        st, 1, 3, (0.0, 5.0), (-3.0, 5.0), (0.0, 0.5), (-3.0, 0.5), 1.5),
    "add_gear_joint": lambda m, s, k, st: m.add_gear_joint(
        st, ("revolute", 0), ("prismatic", 0), 2.0),
    "set_mouse_target": lambda m, s, k, st: m.set_mouse_target(
        m.add_mouse_joint(st, 1, (0.2, 0.9), max_force=100.0)[0], 0, (1.0, 2.0)),
    "remove_joint": lambda m, s, k, st: m.remove_joint(st, "revolute", 0),
    "set_awake_false": lambda m, s, k, st: m.set_awake(
        m.apply_force(st, 4, (1.0, 1.0), (0.0, 3.2)), 4, False),
    "set_awake_true": lambda m, s, k, st: m.set_awake(m.set_awake(st, 2, False), 2, True),
    "shift_origin": lambda m, s, k, st: m.shift_origin(
        m.add_pulley_joint(m.add_mouse_joint(st, 1, (0.2, 0.9))[0], 1, 3, (0.0, 5.0),
                           (-3.0, 5.0), (0.0, 0.5), (-3.0, 0.5))[0], (2.0, -1.0)),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_mutate_matches_jax(base, case):
    """The same call on the same world in both packages; the index a
    creating call returns equal too."""
    jst, tst = base
    fn = _CASES[case]
    jout = fn(jmutate, jshapes, jsettings, jst)
    tout = fn(mutate, shapes, settings, tst)
    if isinstance(jout, tuple):
        (jout, jidx), (tout, tidx) = jout, tout
        assert tidx.shape == (1,) and tidx.dtype == torch.int32
        assert int(tidx[0]) == int(jidx) >= 0
    _assert_same(jout, tout)
    # pure: the state passed in is left as it was
    _assert_same(jst, tst)


def test_mutate_batched(base):
    """Two worlds with different first free slots: each world of a batched
    call equals the one-world call on that world alone; -1 leaves a world
    as it is."""
    _, one = base
    other, _ = mutate.add_body(one, body_type=settings.DYNAMIC_BODY, position=(1.0, 1.0))
    other, _ = mutate.add_fixture(other, 5, shapes.Polygon.box(0.2, 0.2), density=1.0)
    pair = concat_worlds([one, other])
    split = lambda st, w: map_leaves(lambda t: t[w:w + 1], st)  # noqa: E731

    steps = [
        lambda m, st, w: m.add_body(st, body_type=settings.DYNAMIC_BODY,
                                    position=(4.0, 4.0), angle=0.1),
        lambda m, st, w: m.add_fixture(st, w(5, 6), shapes.Circle(0.4), density=2.0),
        lambda m, st, w: m.add_revolute_joint(st, 1, w(5, 2), (0.5, 1.0)),
        lambda m, st, w: m.set_linear_velocity(st, w(-1, 3), (2.0, 0.0)),
        lambda m, st, w: m.remove_body(st, w(2, -1)),
        lambda m, st, w: m.set_contact_tangent_speed(st, 0, w(1, 3), 4.0),
    ]
    idx = {}
    for k, step in enumerate(steps):
        out = step(mutate, pair, lambda a, b: torch.tensor([a, b]))
        singles = [step(mutate, split(pair, w), lambda a, b, w=w: (a, b)[w]) for w in (0, 1)]
        if isinstance(out, tuple):
            out, got = out
            singles, want = zip(*singles)
            idx[k] = got.tolist()
            assert got.tolist() == [int(i[0]) for i in want]
        for w, single in enumerate(singles):
            for (name, a), (_, b) in zip(_leaves(split(out, w)), _leaves(single)):
                assert torch.equal(a, b), f"step {k}, world {w}: {name}"
        pair = out
    # the worlds' first free slots differ, and the created rows landed there
    assert idx[0] == [5, 6] and idx[1][0] != idx[1][1]
    assert not bool(pair.bodies.v[0, 3].any()) and float(pair.bodies.v[1, 3, 0]) == 2.0


# ---------------------------------------------------------------------------
# the mutation goldens as one padded batch
# ---------------------------------------------------------------------------

_CAPACITY = dict(body_capacity=8, fixture_capacity=8, contact_capacity=64)
# world: (golden file, steps it covers, bound on the worst error)
_GOLDENS = {"shape_editing": ("shape_editing_240", 240, 0.05),
            "breakable": ("breakable_240", 167, 0.1),
            "collision_processing": ("collision_processing_240", 240, 0.2),
            "skier": ("skier_180", 180, 0.02)}
_BREAK_STEP = 167


def _at(w, i, n=len(_GOLDENS)):
    t = torch.full((n,), -1, dtype=torch.long)
    t[w] = int(i)
    return t


def _break(st, w, velocity, angular):
    """Breakable.h's Break(): the second half-box becomes its own body;
    both pieces get the velocities cached before the impact step."""
    center = st.bodies.c[w, 1].clone()
    st = mutate.remove_fixture(st, _at(w, 2))
    only = torch.zeros(st.n_worlds, dtype=torch.bool)
    only[w] = True
    st, b2 = mutate.add_body(st, body_type=settings.DYNAMIC_BODY,
                             position=st.bodies.xf_p[w, 1], angle=st.bodies.a[w, 1],
                             worlds=only)
    b2 = int(b2[w])
    assert b2 == 2
    st, _ = mutate.add_fixture(st, _at(w, b2), shapes.Polygon.box(0.5, 0.5, (0.5, 0.0), 0.0),
                               density=1.0)
    for b in (1, b2):
        r = st.bodies.c[w, b] - center
        st = mutate.set_angular_velocity(st, _at(w, b), angular)
        st = mutate.set_linear_velocity(
            st, _at(w, b), velocity + torch.stack([-angular * r[1], angular * r[0]]))
    return st


@pytest.fixture(scope="module")
def golden_roll():
    """The four worlds rolled 240 steps with their scripts; per world the
    worst error against its trace and the step of breakable's break."""
    names = list(_GOLDENS)
    se, br, cp, sk = range(4)
    st = concat_worlds([getattr(scenes, n)(device="cpu", **_CAPACITY) for n in names])
    st = mutate.set_transform(st, _at(sk, 1), (-0.7, float(st.bodies.xf_p[sk, 1, 1])), 0.0)
    refs = [[json.loads(line) for line in open(GOLDEN / f"{f}.jsonl")]
            for f, _, _ in _GOLDENS.values()]
    errs = [[] for _ in names]
    counts_ok = [True] * 4
    fixture2 = None
    broke = do_break = False
    break_step, velocity, angular, tail = -1, None, 0.0, []
    for i in range(240):
        if i == 60:        # ShapeEditing.h 'C', 'S', 'D' at steps 60, 120, 180
            st, fixture2 = mutate.add_fixture(st, _at(se, 1), shapes.Circle(3.0, (0.5, -4.0)),
                                              density=10.0)
            st = mutate.set_awake(st, _at(se, 1), True)
        elif i == 120:
            st = mutate.set_sensor(st, fixture2, True)
        elif i == 180:
            st = mutate.remove_fixture(st, fixture2)
            st = mutate.set_awake(st, _at(se, 1), True)
        if do_break and not broke:
            st = _break(st, br, velocity, angular)
            broke, do_break, break_step = True, False, i
        if not broke:
            velocity, angular = st.bodies.v[br, 1].clone(), float(st.bodies.w[br, 1])
        st, ev = world.step_batched(st, 1 / 60)
        impulse = max(float(ev.normal_impulse[br].max()), float(ev.toi_normal_impulse[br].max()))
        if not broke and impulse > 40.0:
            do_break = True
        p, a, bt = st.bodies.xf_p.numpy(), st.bodies.a.numpy(), st.bodies.body_type.numpy()
        for w, ref in enumerate(refs):
            if i >= len(ref):
                continue
            slots = [k for k in range(bt.shape[1] - 1, -1, -1) if bt[w, k] >= 0]
            if len(slots) != len(ref[i]["bodies"]):
                counts_ok[w] = False
                continue
            errs[w].append(max(max(abs(p[w, k, 0] - rb[0]), abs(p[w, k, 1] - rb[1]),
                                   abs(a[w, k] - rb[2]))
                               for k, rb in zip(slots, ref[i]["bodies"])))
        if broke:
            tail.append(np.concatenate([p[br, :3], a[br, :3, None]], -1))
        # CollisionProcessing.h: destroy the lighter body of every touching
        # dynamic pair
        fa, fb = ev.f_a[cp].numpy(), ev.f_b[cp].numpy()
        fxb, inv_m = st.fixtures.body[cp].numpy(), st.bodies.inv_mass[cp].numpy()
        nuke = set()
        for ci in np.flatnonzero(ev.touching[cp].numpy()):
            ba, bb = int(fxb[fa[ci]]), int(fxb[fb[ci]])
            if min(ba, bb) < 0 or min(bt[cp, ba], bt[cp, bb]) < 0:
                continue
            if inv_m[ba] > 0 and inv_m[bb] > 0:
                nuke.add(ba if 1 / inv_m[bb] > 1 / inv_m[ba] else bb)
        for b in sorted(nuke):
            st = mutate.remove_body(st, _at(cp, b))
    return dict(errs=errs, counts_ok=counts_ok, break_step=break_step, tail=np.stack(tail),
                final_live=int((st.bodies.body_type[cp] >= 0).sum()),
                names=names, refs=refs)


@pytest.mark.parametrize("scene", list(_GOLDENS))
def test_port_meets_mutation_golden(golden_roll, scene):
    """Each world against its C++ trace at the JAX package's bound, over
    the steps the bound covers; the body count equal at every step."""
    w = golden_roll["names"].index(scene)
    _, steps, bound = _GOLDENS[scene]
    errs = np.asarray(golden_roll["errs"][w])
    print(f"{scene}: worst error {errs[:steps].max():.4g} over steps 0-{steps - 1}, "
          f"{errs.max():.4g} over all")
    assert golden_roll["counts_ok"][w]
    assert errs[:steps].max() < bound
    if scene == "breakable":
        assert golden_roll["break_step"] == _BREAK_STEP
    if scene == "skier":
        assert errs[-1] < 5e-3
    if scene == "collision_processing":
        assert golden_roll["final_live"] == len(golden_roll["refs"][w][-1]["bodies"])


def test_breakable_after_the_break_equals_jax(golden_roll):
    """Steps 167-239: the JAX package rolled with the same break at step
    167 (its own events miss it) gives the port's trajectory."""
    st = jscenes.breakable()
    kinds = jworld.possible_kinds(st)
    velocity, angular, kept = None, 0.0, []
    for i in range(240):
        if i == _BREAK_STEP:
            center = np.asarray(st.bodies.c)[1].copy()
            st = jmutate.remove_fixture(st, 2)
            st, b2 = jmutate.add_body(st, body_type=jsettings.DYNAMIC_BODY,
                                      position=tuple(np.asarray(st.bodies.xf_p)[1]),
                                      angle=float(np.asarray(st.bodies.a)[1]))
            b2 = int(b2)
            st, _ = jmutate.add_fixture(st, b2, jshapes.Polygon.box(0.5, 0.5, (0.5, 0.0), 0.0),
                                        density=1.0)
            for b in (1, b2):
                r = np.asarray(st.bodies.c)[b] - center
                st = jmutate.set_angular_velocity(st, b, angular)
                st = jmutate.set_linear_velocity(
                    st, b, tuple(velocity + np.array([-angular * r[1], angular * r[0]])))
        if i < _BREAK_STEP:
            velocity = np.asarray(st.bodies.v)[1].copy()
            angular = float(np.asarray(st.bodies.w)[1])
        st, _ = jworld.step(st, 1 / 60, kinds=kinds)
        if i >= _BREAK_STEP:
            kept.append(np.concatenate([np.asarray(st.bodies.xf_p)[:3],
                                        np.asarray(st.bodies.a)[:3, None]], -1))
    diff = np.abs(np.stack(kept) - golden_roll["tail"]).max()
    print(f"breakable after the break: max |port - JAX| {diff:.3g}")
    assert diff < 1e-3
