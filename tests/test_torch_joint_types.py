"""The port's mouse, friction, rope, motor, wheel, pulley and gear joints
against the JAX package and the C++ goldens.

  * the joint solver: one world on 24 bodies holds every variant (mouse;
    friction; rope slack and taut; motor; wheel with motor and spring and
    without; pulley; gears revolute-revolute and revolute-prismatic with
    the joints they couple; and one distance and one weld joint, so that
    all eleven types run together). Body data and stored impulses come
    from a numpy seed. The world goes through `init_joints` ->
    `warm_start_joints` -> two `solve_joint_velocity` -> two
    `solve_joint_position` -> `store_joint_impulses` in both packages;
    the JAX functions run once, jitted together, in a module fixture.
    Tolerance: atol 1e-5 (the same float32 operations in the same order;
    sin/cos/sqrt/divide and XLA's fusion may differ in the last bits, and
    the gear adds its four deltas at once where JAX adds them in turn);
    colors (a mouse joint is a self-edge of the coloring), active masks
    and the per-body convergence flags are equal;
  * builder, state bridge and scenes: the port's builder makes the JAX
    builder's eleven blocks, padding included; `state_from_numpy`
    round-trips them; the eight scenes of these types equal the JAX-built
    states leaf for leaf;
  * pair table: a mouse joint with collide_connected=False forbids no
    pair, as in the JAX package;
  * the six joint goldens of tests/test_step.py rolled 240 steps as one
    padded batch of worlds, at that file's bounds.
"""

import dataclasses
import json
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from box2d_mt_tpu import settings as jsettings
from box2d_mt_tpu import shapes as jshapes
from box2d_mt_tpu import world as jworld
from box2d_mt_tpu.joints import solver as jsolver
from box2d_mt_tpu.models import scenes as jscenes
from box2d_mt_tpu_torch import settings as tsettings
from box2d_mt_tpu_torch import shapes as tshapes
from box2d_mt_tpu_torch import world as tworld
from box2d_mt_tpu_torch.joints import solver as tsolver
from box2d_mt_tpu_torch.models import scenes as tscenes
from box2d_mt_tpu_torch.state import (JOINT_BLOCKS, concat_worlds, replicate,
                                      state_from_numpy, to_numpy)

from conftest import GOLDEN

DT = 1.0 / 60.0
NB = 24          # bodies: slot 0 static, the rest dynamic
MAX_COLORS = 16
DT_RATIO = 0.9
ATOL = 1e-5
# slots of each kind beyond the world's own, in the builder comparison
PAD = 2


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """These tensors are a few worlds wide: PyTorch's intra-op threads cost
    more than they give, and workers running side by side share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _build(world, shapes, settings, seed=0, **freeze_kw):
    """Every joint variant between bodies at random poses, built with
    `world`'s builder; both packages' builders make the same calls with
    the same random numbers."""
    rng = np.random.default_rng(seed)
    wb = world.WorldBuilder(gravity=(0.0, -10.0))
    wb.create_body()
    pose = [((0.0, 0.0), 0.0)]
    for i in range(1, NB):
        pose.append((tuple(rng.uniform(-3, 3, 2)), float(rng.uniform(-0.5, 0.5))))
        b = wb.create_body(body_type=settings.DYNAMIC_BODY, position=pose[i][0],
                           angle=pose[i][1], fixed_rotation=(i == 5))
        wb.create_fixture(b, shapes.Polygon.box(0.5, 0.25), density=1.0 + i % 3)
    order = iter(rng.permutation(np.arange(1, NB)).tolist())

    def ends():
        a, b = (int(x) for x in rng.choice(NB, 2, replace=False))
        mid = 0.5 * (np.asarray(pose[a][0]) + np.asarray(pose[b][0]))
        return a, b, tuple(mid + rng.uniform(-0.5, 0.5, 2))

    # mouse joints on distinct bodies; the last two are held to small forces
    for max_force in (1000.0, 5.0, 0.5):
        b = next(order)
        wb.create_mouse_joint(b, tuple(np.asarray(pose[b][0]) + rng.uniform(-0.5, 0.5, 2)),
                              max_force=max_force, frequency=rng.uniform(2, 6),
                              damping_ratio=rng.uniform(0.3, 1.0))
    for _ in range(3):
        wb.create_friction_joint(*ends(), max_force=rng.uniform(0.5, 5),
                                 max_torque=rng.uniform(0.5, 5))
    # ropes: two slack (longer than the anchors' distance), two taut
    for factor in (1.2, 1.3, 0.85, 0.9):
        a, b, _ = ends()
        la, lb = tuple(rng.uniform(-0.4, 0.4, 2)), tuple(rng.uniform(-0.4, 0.4, 2))
        wa = _world_point(pose[a], la)
        wbp = _world_point(pose[b], lb)
        wb.create_rope_joint(a, b, la, lb, factor * math.dist(wa, wbp))
    for _ in range(3):
        a, b, _ = ends()
        wb.create_motor_joint(a, b, max_force=rng.uniform(1, 50),
                              max_torque=rng.uniform(1, 50),
                              correction_factor=rng.uniform(0.1, 0.5))
    # wheels: two with motor and spring, two without
    for i in range(4):
        ang = rng.uniform(0, 2 * np.pi)
        wb.create_wheel_joint(*ends(), (np.cos(ang), np.sin(ang)),
                              enable_motor=i < 2, motor_speed=rng.uniform(-5, 5),
                              max_motor_torque=rng.uniform(1, 20),
                              frequency=rng.uniform(2, 6) if i < 2 else 0.0,
                              damping_ratio=rng.uniform(0.3, 1.0))
    for _ in range(2):
        a, b, _ = ends()
        pa, pb = np.asarray(pose[a][0]), np.asarray(pose[b][0])
        wb.create_pulley_joint(a, b, tuple(pa + (0.0, 3.0)), tuple(pb + (0.0, 3.0)),
                               tuple(pa + rng.uniform(-0.3, 0.3, 2)),
                               tuple(pb + rng.uniform(-0.3, 0.3, 2)),
                               rng.uniform(0.5, 2.0))
    wb.create_distance_joint(*ends()[:2], tuple(pose[1][0]), tuple(pose[2][0]))
    wb.create_weld_joint(*ends())
    # gears: revolute-revolute on two ground pins, and revolute-prismatic
    g = [next(order) for _ in range(5)]
    rev = [wb.create_revolute_joint(0, b, pose[b][0]) for b in g[:3]]
    ang = rng.uniform(0, 2 * np.pi)
    prism = wb.create_prismatic_joint(g[3], g[4], pose[g[4]][0], (np.cos(ang), np.sin(ang)))
    wb.create_gear_joint(("revolute", rev[0]), ("revolute", rev[1]), ratio=2.0)
    wb.create_gear_joint(("revolute", rev[2]), ("prismatic", prism), ratio=-0.5)
    return wb.freeze(body_capacity=NB, **freeze_kw)


def _world_point(pose, local):
    (px, py), ang = pose
    s, c = math.sin(ang), math.cos(ang)
    return (px + c * local[0] - s * local[1], py + s * local[0] + c * local[1])


def _solver_world():
    """The JAX state of `_build`, its bodies then moved a little (0.04 m,
    0.15 rad) from the build pose, with random velocities, awake flags
    and stored impulses."""
    st = _build(jworld, jshapes, jsettings)
    rng = np.random.default_rng(1)
    f32 = lambda x: jnp.asarray(np.asarray(x, np.float32))
    b = st.bodies
    bodies = dataclasses.replace(
        b, c=b.c + f32(rng.uniform(-0.04, 0.04, (NB, 2))),
        a=b.a + f32(rng.uniform(-0.15, 0.15, NB)),
        v=f32(rng.uniform(-0.3, 0.3, (NB, 2))), w=f32(rng.uniform(-0.3, 0.3, NB)),
        awake=jnp.asarray(rng.uniform(size=NB) < 0.75))

    def stored(blk):
        return dataclasses.replace(blk, **{
            f.name: f32(rng.uniform(-0.2, 0.2, getattr(blk, f.name).shape))
            for f in dataclasses.fields(blk) if f.name.endswith("impulse")})

    joints = dataclasses.replace(st.joints, **{
        name: stored(getattr(st.joints, name)) for name, _ in JOINT_BLOCKS})
    return dataclasses.replace(st, bodies=bodies, joints=joints)


def _jax_solve(jst):
    """The JAX package's joint passes on `jst`: init, warm start, two
    velocity and two position passes, store."""
    jb = jst.bodies
    jdata, jstate = jsolver.init_joints(
        jst.joints, jb, jb.awake, jb.v, jb.w, jnp.float32(DT),
        jnp.float32(DT_RATIO), True, NB, MAX_COLORS)
    init_state = jstate
    v, w = jsolver.warm_start_joints(jdata, jstate, jb.v, jb.w)
    for _ in range(2):
        jstate, v, w = jsolver.solve_joint_velocity(jdata, jstate, v, w,
                                                    jnp.float32(DT), MAX_COLORS)
    c, a = jb.c, jb.a
    for _ in range(2):
        c, a, jok = jsolver.solve_joint_position(jdata, jstate, c, a, MAX_COLORS)
    colored = {k: d for k, (_, d) in jdata.items() if k != "gear"}
    return dict(init_state=init_state, state=jstate, v=v, w=w, c=c, a=a, jok=jok,
                joints=jsolver.store_joint_impulses(jst.joints, jstate),
                color={k: d.com.color for k, d in colored.items()},
                active={**{k: d.com.active for k, d in colored.items()},
                        "gear": jdata["gear"][1].active})


@pytest.fixture(scope="module")
def solved():
    jst = _solver_world()
    tst = state_from_numpy(jax.tree.map(np.asarray, jst), device="cpu")
    jax_out = types.SimpleNamespace(**jax.tree.map(np.asarray, jax.jit(_jax_solve)(jst)))

    tb = tst.bodies
    dt = float(np.float32(DT))
    tdata, tstate = tsolver.init_joints(
        tst.joints, tb, tb.awake, tb.v, tb.w, dt,
        torch.full((1,), DT_RATIO), True, NB, MAX_COLORS)
    t_init = tstate
    tv, tw = tsolver.warm_start_joints(tdata, tstate, tb.v, tb.w)
    for _ in range(2):
        tstate, tv, tw = tsolver.solve_joint_velocity(tdata, tstate, tv, tw, dt)
    tc, ta = tb.c, tb.a
    for _ in range(2):
        tc, ta, tok = tsolver.solve_joint_position(tdata, tstate, tc, ta)
    port_out = types.SimpleNamespace(
        init_state=t_init, state=tstate, v=tv, w=tw, c=tc, a=ta, jok=tok,
        joints=tsolver.store_joint_impulses(tst.joints, tstate), data=tdata)
    return jst, jax_out, port_out


# variant: (block, its lanes as a function of the block's numpy leaves)
_VARIANTS = {
    "mouse": ("mouse", lambda b: b.active),
    "friction": ("friction", lambda b: b.active),
    "rope-slack": ("rope", lambda b: np.arange(b.active.size) < 2),
    "rope-taut": ("rope", lambda b: np.arange(b.active.size) >= 2),
    "motor": ("motor", lambda b: b.active),
    "wheel-motor-spring": ("wheel", lambda b: b.enable_motor),
    "wheel-plain": ("wheel", lambda b: ~b.enable_motor),
    "pulley": ("pulley", lambda b: b.active),
    "gear-revolute-revolute": ("gear", lambda b: b.joint2_type == 0),
    "gear-revolute-prismatic": ("gear", lambda b: b.joint2_type == 1),
}


@pytest.mark.parametrize("variant", list(_VARIANTS))
def test_joint_type_solver_matches_jax(solved, variant):
    """atol 1e-5 on impulses; colors and active masks equal."""
    jst, jx, pt = solved
    name, select = _VARIANTS[variant]
    lanes = select(jax.tree.map(np.asarray, getattr(jst.joints, name)))
    assert lanes.sum() >= 1
    if name == "gear":
        active = pt.data.gear[1].active
    else:
        com = pt.data.blocks[name][1].com
        np.testing.assert_array_equal(com.color[0].numpy()[lanes], jx.color[name][lanes])
        active = com.active
    np.testing.assert_array_equal(active[0].numpy()[lanes], jx.active[name][lanes])
    assert jx.active[name][lanes].any()
    for stage, jstate, tstate in (("init", jx.init_state, pt.init_state),
                                  ("solved", jx.state, pt.state)):
        assert set(tstate[name]) == set(jstate[name])
        for key, ref in jstate[name].items():
            np.testing.assert_allclose(tstate[name][key][0].numpy()[lanes], ref[lanes],
                                       rtol=0, atol=ATOL, err_msg=f"{stage} {key}")
    stored, ref = getattr(pt.joints, name), getattr(jx.joints, name)
    for f in dataclasses.fields(stored):
        np.testing.assert_allclose(getattr(stored, f.name)[0].numpy()[lanes],
                                   getattr(ref, f.name)[lanes], rtol=0, atol=ATOL,
                                   err_msg=f.name)


def test_joint_types_bodies_match_jax(solved):
    """The body state after all eleven types ran (atol 1e-5) and the
    per-body convergence flags (equal); the variants do what they are
    there for."""
    _, jx, pt = solved
    for key in ("v", "w", "c", "a"):
        np.testing.assert_allclose(getattr(pt, key)[0].numpy(), getattr(jx, key),
                                   rtol=0, atol=ATOL, err_msg=key)
    np.testing.assert_array_equal(pt.jok[0].numpy(), jx.jok)
    assert not jx.jok.all() and jx.jok.any()
    assert set(pt.data.blocks) | {"gear"} == {n for n, _ in JOINT_BLOCKS}
    rope = jx.state["rope"]["impulse"]
    assert (rope[2:] < 0).all() and (rope[:2] == 0).all()     # taut pull, slack not
    # the small mouse forces and the friction joints hit their clamps
    mouse = np.linalg.norm(jx.state["mouse"]["impulse"], axis=-1)
    assert np.isclose(mouse[2], DT * 0.5, rtol=1e-5)
    assert np.abs(jx.state["gear"]["impulse"]).min() > 0


def _joint_leaves(joints):
    for name, _ in JOINT_BLOCKS:
        blk = getattr(joints, name)
        for f in dataclasses.fields(blk):
            yield f"{name}.{f.name}", getattr(blk, f.name)


def test_builder_and_state_bridge_round_trip_all_blocks(solved):
    """The port's builder makes the JAX builder's eleven blocks, padded
    with PAD inactive slots each; a JAX state's blocks cross over and
    back unchanged."""
    cap = {name: PAD + n for name, n in
           (("revolute", 3), ("distance", 1), ("prismatic", 1), ("mouse", 3),
            ("weld", 1), ("friction", 3), ("rope", 4), ("motor", 3), ("wheel", 4),
            ("pulley", 2), ("gear", 2))}
    mine = to_numpy(_build(tworld, tshapes, tsettings, joint_capacity=cap, device="cpu"))
    ref = jax.tree.map(np.asarray, _build(jworld, jshapes, jsettings, joint_capacity=cap))
    for name, leaf in _joint_leaves(mine.joints):
        blk, _, f = name.partition(".")
        want = getattr(getattr(ref.joints, blk), f)
        assert want.shape[0] == cap[blk], name
        assert leaf.dtype == want.dtype and np.array_equal(leaf[0], want), name
    assert not ref.joints.gear.active[-PAD:].any()
    host = jax.tree.map(np.asarray, solved[0])
    st = replicate(state_from_numpy(host, device="cpu"), 3)
    assert st.joints.count == 27 and st.cache.sig_jact.shape == (3, 27)
    for name, leaf in _joint_leaves(st.joints):
        blk, _, f = name.partition(".")
        want = getattr(getattr(host.joints, blk), f)
        assert leaf.shape == (3,) + want.shape and leaf.numpy().dtype == want.dtype, name
        assert np.array_equal(leaf[2].numpy(), want), name
    back = state_from_numpy(to_numpy(st), device="cpu")
    for (name, x), (_, y) in zip(_joint_leaves(st.joints), _joint_leaves(back.joints)):
        assert x.dtype == y.dtype and torch.equal(x, y), name


_SCENES = ("friction_top_down", "rope_swing", "motor_drive", "wheel_car", "gear_train",
           "pulley_pair", "car", "apply_force")


@pytest.mark.parametrize("scene", _SCENES)
def test_port_scene_equals_jax_scene(scene):
    """Bit for bit, every leaf: bodies, fixtures, the initial pair table,
    the cache and all eleven joint blocks."""
    jn = jax.tree.map(np.asarray, getattr(jscenes, scene)())
    tn = to_numpy(getattr(tscenes, scene)(device="cpu"))
    for grp in ("bodies", "fixtures", "contacts", "cache"):
        for f in dataclasses.fields(getattr(tn, grp)):
            got, ref = getattr(getattr(tn, grp), f.name), getattr(getattr(jn, grp), f.name)
            assert got.dtype == ref.dtype and np.array_equal(got[0], ref), f"{grp}.{f.name}"
    for name, got in _joint_leaves(tn.joints):
        blk, _, f = name.partition(".")
        ref = getattr(getattr(jn.joints, blk), f)
        assert got.dtype == ref.dtype and got[0].shape == ref.shape, name
        assert np.array_equal(got[0], ref), name
    assert tn.joints.count > 0


def _mouse_on_ground(world, shapes, settings, **freeze_kw):
    wb = world.WorldBuilder(gravity=(0.0, -10.0))
    ground = wb.create_body()
    wb.create_fixture(ground, shapes.Edge((-5.0, 0.0), (5.0, 0.0)))
    box = wb.create_body(body_type=settings.DYNAMIC_BODY, position=(0.0, 0.5))
    wb.create_fixture(box, shapes.Polygon.box(0.5, 0.5), density=1.0)
    wb.create_joint_raw("mouse", body_a=ground, body_b=box, target=(2.0, 0.5),
                        local_anchor_b=(0.0, 0.0), max_force=1000.0, frequency=5.0,
                        damping_ratio=0.7, collide_connected=False)
    return wb.freeze(**freeze_kw)


def test_mouse_joint_forbids_no_pair():
    """A mouse joint with collide_connected=False between the ground and
    a box on it: the JAX package leaves the mouse block out of the
    forbidden pairs, so the box still pairs with the ground."""
    tst = _mouse_on_ground(tworld, tshapes, tsettings, device="cpu")
    jst = jax.tree.map(np.asarray, _mouse_on_ground(jworld, jshapes, jsettings))
    np.testing.assert_array_equal(tst.contacts.f_a[0].numpy(), jst.contacts.f_a)
    np.testing.assert_array_equal(tst.contacts.f_b[0].numpy(), jst.contacts.f_b)
    assert int((tst.contacts.f_a >= 0).sum()) == 1


# the goldens of tests/test_step.py: (scene, bodies in the trace, bound on
# the worst error); the gear's bounds are checked in the test
_GOLDENS = {
    "friction_240": ("friction_top_down", 2, 5e-3),
    "rope_240": ("rope_swing", 2, 2e-2),
    "motor_240": ("motor_drive", 2, 5e-3),
    "wheel_240": ("wheel_car", 3, 5e-2),
    "gear_240": ("gear_train", 4, 0.03),
    "pulley_240": ("pulley_pair", 3, 1e-2),
}
# the capacities of the largest of them, so that the six roll as one batch
# of worlds; the empty slots take no part
_GOLDEN_CAPACITY = dict(
    body_capacity=4, fixture_capacity=4, contact_capacity=64,
    joint_capacity={"revolute": 2, "prismatic": 1, "friction": 1, "rope": 1, "motor": 1,
                    "wheel": 1, "pulley": 1, "gear": 2})


@pytest.fixture(scope="module")
def golden_errors():
    """Each golden's error per step over 240 steps against the C++ trace
    (bodies listed in reverse creation order), and whether every step was
    free of color and pair overflow."""
    st = concat_worlds([getattr(tscenes, scene)(device="cpu", **_GOLDEN_CAPACITY)
                        for scene, _, _ in _GOLDENS.values()])
    refs = [[json.loads(line) for line in open(GOLDEN / f"{name}.jsonl")]
            for name in _GOLDENS]
    errs, clean = np.zeros((len(_GOLDENS), 240)), True
    for i in range(240):
        # inference mode skips autograd's dispatch: the same values in
        # less host time
        with torch.inference_mode():
            st, ev = tworld.step_batched(st, 1 / 60, velocity_iterations=8,
                                         position_iterations=3)
        p, a = st.bodies.xf_p.numpy(), st.bodies.a.numpy()
        for w, ((_, n_bodies, _), ref) in enumerate(zip(_GOLDENS.values(), refs)):
            for j, rb in enumerate(ref[i]["bodies"]):
                k = n_bodies - 1 - j
                errs[w, i] = max(errs[w, i], abs(p[w, k, 0] - rb[0]),
                                 abs(p[w, k, 1] - rb[1]), abs(a[w, k] - rb[2]))
        clean &= int(ev.color_overflow.max()) == 0 and int(ev.pair_overflow.max()) == 0
    return {name: (errs[w], clean) for w, name in enumerate(_GOLDENS)}


@pytest.mark.parametrize("golden", list(_GOLDENS))
def test_port_meets_cpp_golden(golden_errors, golden):
    """240 steps against the C++ trace, at the JAX package's bounds for
    the scene (tests/test_step.py)."""
    errs, clean = golden_errors[golden]
    assert clean
    assert errs.max() < _GOLDENS[golden][2]
    if golden == "gear_240":
        assert errs[:130].max() < 1e-4      # free gearing
        assert errs[-1] < 1e-4              # settled after the rack's limit impact
