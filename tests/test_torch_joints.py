"""The port's revolute, distance, prismatic and weld joints against the JAX
package and the C++ goldens (the seven other types:
tests/test_torch_joint_types.py).

  * the joint solver: one world that holds every variant (revolute and
    prismatic with limits and motors, distance and weld rigid and soft) on
    24 bodies goes through `init_joints` -> `warm_start_joints` -> two
    `solve_joint_velocity` -> two `solve_joint_position` ->
    `store_joint_impulses` in both packages; body data, stored impulses
    and limit states come from a numpy seed. The JAX functions run once,
    jitted together, in a module fixture; each case checks its variant's
    joints. Tolerance: atol 1e-5 (both run the same float32 operations in
    the same order; sin/cos/sqrt/divide, and XLA's fusion of the jitted
    sequence, may differ in the last bits);
    limit states and the per-body convergence flags are equal;
  * builder, state bridge and scenes: field-by-field equality with the JAX
    package, the numpy round trip, refusal of an unknown joint kind;
  * forbidden pairs: jointed bodies with collide_connected=False make no
    pair, and the pair table equals the JAX package's;
  * the port alone against the C++ goldens at the bounds of the JAX
    package's own tests (tests/test_step.py), the four rolled as one
    batch of worlds.
"""

import dataclasses
import json
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
from box2d_mt_tpu_torch import joints as tjoints
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
# the joint types of the solver world; its other blocks are empty
FOUR_TYPES = ("revolute", "distance", "prismatic", "weld")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """These tensors are a few worlds wide: PyTorch's intra-op threads cost
    more than they give, and workers running side by side share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _solver_world(seed=0):
    """A JAX state with every joint variant between random bodies. The
    joints hold at the build pose; the bodies are then moved a little
    (0.04 m, 0.15 rad), so that every limit state occurs and the position
    corrections stay small, and get random velocities, stored impulses
    and limit states."""
    rng = np.random.default_rng(seed)
    wb = jworld.WorldBuilder(gravity=(0.0, -10.0))
    wb.create_body()
    pose = [((0.0, 0.0), 0.0)]
    for i in range(1, NB):
        pose.append((tuple(rng.uniform(-3, 3, 2)), rng.uniform(-0.5, 0.5)))
        b = wb.create_body(body_type=jsettings.DYNAMIC_BODY, position=pose[i][0],
                           angle=pose[i][1], fixed_rotation=(i == 5))
        wb.create_fixture(b, jshapes.Polygon.box(0.5, 0.25), density=1.0 + i % 3)

    def ends():
        a, b = (int(x) for x in rng.choice(NB, 2, replace=False))
        mid = 0.5 * (np.asarray(pose[a][0]) + np.asarray(pose[b][0]))
        return a, b, tuple(mid + rng.uniform(-0.5, 0.5, 2))

    def limits(i, scale):
        # around the build pose (coordinate 0): nearly equal, or a narrow
        # window that the perturbation crosses
        if i in (1, 2):
            return -0.002, 0.002
        lo = scale * rng.uniform(-0.04, 0.02)
        return lo, lo + scale * rng.uniform(0.02, 0.03)

    for i in range(12):
        lo, hi = limits(i, 4.0)       # wider than 2 * ANGULAR_SLOP
        wb.create_revolute_joint(
            *ends(), enable_limit=i != 0, lower_angle=lo, upper_angle=hi,
            enable_motor=i % 2 == 0, motor_speed=rng.uniform(-2, 2),
            max_motor_torque=rng.uniform(1, 50))
    for i in range(8):
        a, b, anchor = ends()
        wb.create_distance_joint(
            a, b, anchor, tuple(np.asarray(anchor) + rng.uniform(-1, 1, 2)),
            frequency=0.0 if i < 4 else rng.uniform(1, 8),
            damping_ratio=rng.uniform(0, 1))
    for i in range(12):
        ang = rng.uniform(0, 2 * np.pi)
        lo, hi = limits(i, 1.0)
        wb.create_prismatic_joint(
            *ends(), (np.cos(ang), np.sin(ang)), enable_limit=i != 0,
            lower_translation=lo, upper_translation=hi,
            enable_motor=i % 2 == 0, motor_speed=rng.uniform(-2, 2),
            max_motor_force=rng.uniform(1, 50))
    for i in range(8):
        wb.create_weld_joint(
            *ends(), frequency=0.0 if i < 4 else rng.uniform(1, 8),
            damping_ratio=rng.uniform(0, 1))
    st = wb.freeze(body_capacity=NB)

    f32 = lambda x: jnp.asarray(np.asarray(x, np.float32))
    b = st.bodies
    awake = rng.uniform(size=NB) < 0.5
    bodies = dataclasses.replace(
        b, c=b.c + f32(rng.uniform(-0.04, 0.04, (NB, 2))),
        a=b.a + f32(rng.uniform(-0.15, 0.15, NB)),
        v=f32(rng.uniform(-0.3, 0.3, (NB, 2))), w=f32(rng.uniform(-0.3, 0.3, NB)),
        awake=jnp.asarray(awake))

    def stored(blk):
        kw = {"impulse": f32(rng.uniform(-0.2, 0.2, blk.impulse.shape))}
        if hasattr(blk, "motor_impulse"):
            kw["motor_impulse"] = f32(rng.uniform(-0.2, 0.2, blk.motor_impulse.shape))
            kw["limit_state"] = jnp.asarray(
                rng.integers(0, 4, blk.limit_state.shape).astype(np.int32))
        return dataclasses.replace(blk, **kw)

    joints = dataclasses.replace(st.joints, **{
        name: stored(getattr(st.joints, name)) for name in FOUR_TYPES})
    return dataclasses.replace(st, bodies=bodies, joints=joints)


def _jax_solve(jst):
    """The JAX package's joint passes on `jst`, the sequence the port's is
    held against: init, warm start, two velocity and two position passes,
    store."""
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
    return dict(init_state=init_state, state=jstate, v=v, w=w, c=c, a=a, jok=jok,
                joints=jsolver.store_joint_impulses(jst.joints, jstate),
                color={k: d.com.color for k, (_, d) in jdata.items()},
                active={k: d.com.active for k, (_, d) in jdata.items()})


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


_VARIANTS = {
    "revolute-limit-motor": ("revolute", None),
    "distance-rigid": ("distance", False),
    "distance-soft": ("distance", True),
    "prismatic-limit-motor": ("prismatic", None),
    "weld-rigid": ("weld", False),
    "weld-soft": ("weld", True),
}


@pytest.mark.parametrize("variant", list(_VARIANTS))
def test_joint_solver_matches_jax(solved, variant):
    """atol 1e-5 on impulses; colors, active masks and limit states equal."""
    jst, jx, pt = solved
    name, soft = _VARIANTS[variant]
    blk = jax.tree.map(np.asarray, getattr(jst.joints, name))
    lanes = (np.ones_like(blk.active) if soft is None
             else (blk.frequency > 0) == soft)
    assert lanes.sum() >= 4
    _, data = pt.data.blocks[name]
    np.testing.assert_array_equal(data.com.color[0].numpy()[lanes], jx.color[name][lanes])
    np.testing.assert_array_equal(data.com.active[0].numpy()[lanes], jx.active[name][lanes])
    assert jx.active[name][lanes].any()
    for stage, jstate, tstate in (("init", jx.init_state, pt.init_state),
                                  ("solved", jx.state, pt.state)):
        for key, ref in jstate[name].items():
            got = tstate[name][key][0].numpy()
            if key == "limit_state":
                np.testing.assert_array_equal(got[lanes], ref[lanes], err_msg=f"{stage} {key}")
            else:
                np.testing.assert_allclose(got[lanes], ref[lanes], rtol=0, atol=ATOL,
                                           err_msg=f"{stage} {key}")
    if soft is None:
        # every limit state is exercised, and some stored z impulse was reset
        assert set(jx.state[name]["limit_state"].tolist()) == {0, 1, 2, 3}
    stored = getattr(pt.joints, name)
    ref = getattr(jx.joints, name)
    for f in dataclasses.fields(stored):
        got = getattr(stored, f.name)[0].numpy()
        np.testing.assert_allclose(got[lanes], getattr(ref, f.name)[lanes], rtol=0,
                                   atol=ATOL, err_msg=f.name)


def test_joint_solver_bodies_match_jax(solved):
    """The body state after all four types ran (atol 1e-5) and the
    per-body convergence flags (equal)."""
    _, jx, pt = solved
    for key in ("v", "w", "c", "a"):
        np.testing.assert_allclose(getattr(pt, key)[0].numpy(), getattr(jx, key),
                                   rtol=0, atol=ATOL, err_msg=key)
    np.testing.assert_array_equal(pt.jok[0].numpy(), jx.jok)
    assert not jx.jok.all() and jx.jok.any()
    # joints between sleeping bodies are skipped
    assert not all(a.all() for a in jx.active.values())
    assert pt.data.n_colors == max(c.max() for c in jx.color.values()) + 1 > 2
    # each type's passes run for the colors its own joints use
    assert pt.data.used == {name: int(c.max()) + 1 for name, c in jx.color.items()}


def _joint_leaves(joints):
    for name, _ in JOINT_BLOCKS:
        blk = getattr(joints, name)
        for f in dataclasses.fields(blk):
            yield f"{name}.{f.name}", getattr(blk, f.name)


def test_joint_state_round_trip_and_refusal(solved):
    """The state bridge round-trips the joint blocks; the builder's blocks
    equal the JAX builder's; an unknown joint kind is refused."""
    jst = solved[0]
    host = jax.tree.map(np.asarray, jst)
    st = replicate(state_from_numpy(host, device="cpu"), 3)
    assert st.joints.count == 40 and st.cache.sig_jact.shape == (3, 40)
    for name, leaf in _joint_leaves(st.joints):
        blk, _, f = name.partition(".")
        ref = getattr(getattr(host.joints, blk), f)
        assert leaf.shape == (3,) + ref.shape and leaf.numpy().dtype == ref.dtype, name
        assert np.array_equal(leaf[1].numpy(), ref), name
    back = state_from_numpy(to_numpy(st), device="cpu")
    for (name, x), (_, y) in zip(_joint_leaves(st.joints), _joint_leaves(back.joints)):
        assert x.dtype == y.dtype and torch.equal(x, y), name
    # the builder's blocks equal the JAX builder's, padding included
    defs = {"weld": [dict(body_a=0, body_b=1, local_anchor_a=(0.5, 0.25),
                          local_anchor_b=(-0.5, 0.0), reference_angle=0.1,
                          frequency=3.0, damping_ratio=0.5, collide_connected=True)]}
    from box2d_mt_tpu.joints import build_joints as jbuild
    mine = tjoints.build_joints(defs, {"weld": 3, "distance": 2}, device="cpu")
    ref = jax.tree.map(np.asarray, jbuild(defs, {"weld": 3, "distance": 2}))
    for name, leaf in _joint_leaves(mine):
        blk, _, f = name.partition(".")
        assert np.array_equal(leaf[0].numpy(), getattr(getattr(ref, blk), f)), name
    # a friction block crosses over from a JAX state, and a rope block
    # built from a def equals the JAX package's
    wb = jworld.WorldBuilder()
    wb.create_body()
    b = wb.create_body(body_type=jsettings.DYNAMIC_BODY, position=(1.0, 0.0))
    wb.create_friction_joint(0, b, (0.0, 0.0), max_force=1.0, max_torque=1.0)
    host = jax.tree.map(np.asarray, wb.freeze())
    fr = state_from_numpy(host, device="cpu").joints.friction
    for f in dataclasses.fields(fr):
        assert np.array_equal(getattr(fr, f.name)[0].numpy(),
                              getattr(host.joints.friction, f.name)), f.name
    rope = [dict(body_a=0, body_b=1, max_length=2.0)]
    mine = tjoints.build_joints({"rope": rope}, {"rope": 2}, device="cpu").rope
    ref = jax.tree.map(np.asarray, jbuild({"rope": rope}, {"rope": 2})).rope
    for f in dataclasses.fields(mine):
        assert np.array_equal(getattr(mine, f.name)[0].numpy(), getattr(ref, f.name)), f.name
    with pytest.raises(ValueError, match="unknown"):
        tjoints.build_joints({"hinge": []}, device="cpu")


_SCENES = {
    "tumbler": (lambda: jscenes.tumbler(12), lambda: tscenes.tumbler(12, device="cpu")),
    "chain_links": (lambda: jscenes.chain_links(6),
                    lambda: tscenes.chain_links(6, device="cpu")),
    "cantilever": (lambda: jscenes.cantilever(2),
                   lambda: tscenes.cantilever(2, device="cpu")),
    "prismatic_slide": (jscenes.prismatic_slide,
                        lambda: tscenes.prismatic_slide(device="cpu")),
    "weld_pendulum": (lambda: jscenes.weld_pendulum(soft=True),
                      lambda: tscenes.weld_pendulum(soft=True, device="cpu")),
    "revolute_pendulum": (jscenes.revolute_pendulum,
                          lambda: tscenes.revolute_pendulum(device="cpu")),
}


@pytest.mark.parametrize("scene", list(_SCENES))
def test_port_joint_scene_equals_jax_scene(scene):
    """Bit for bit, every leaf: bodies, fixtures, the initial pair table,
    the cache and the four joint blocks; JAX's other blocks are empty."""
    jbuild, tbuild = _SCENES[scene]
    jn = jax.tree.map(np.asarray, jbuild())
    tn = to_numpy(tbuild())
    for grp in ("bodies", "fixtures", "contacts", "cache"):
        for f in dataclasses.fields(getattr(tn, grp)):
            got, ref = getattr(getattr(tn, grp), f.name), getattr(getattr(jn, grp), f.name)
            assert got.dtype == ref.dtype and np.array_equal(got[0], ref), f"{grp}.{f.name}"
    for name, got in _joint_leaves(tn.joints):
        blk, _, f = name.partition(".")
        ref = getattr(getattr(jn.joints, blk), f)
        assert got.dtype == ref.dtype and np.array_equal(got[0], ref), name
    for blk in ("mouse", "friction", "rope", "motor", "wheel", "pulley", "gear"):
        assert getattr(jn.joints, blk).active.size == 0
    assert tn.joints.count > 0


def test_forbidden_pairs_match_jax():
    """chain_links(6): neighbouring planks overlap, and the revolute
    joints (collide_connected=False) keep them out of the pair table."""
    tst = tscenes.chain_links(6, device="cpu")
    jst = jax.tree.map(np.asarray, jscenes.chain_links(6))
    f_a, f_b = tst.contacts.f_a[0].numpy(), tst.contacts.f_b[0].numpy()
    np.testing.assert_array_equal(f_a, jst.contacts.f_a)
    np.testing.assert_array_equal(f_b, jst.contacts.f_b)
    body = tst.fixtures.body[0].numpy()
    pairs = {(body[a], body[b]) for a, b in zip(f_a, f_b) if a >= 0}
    joined = set(zip(tst.joints.revolute.body_a[0].tolist(),
                     tst.joints.revolute.body_b[0].tolist()))
    assert not any((a, b) in joined or (b, a) in joined for a, b in pairs)
    # with the joints switched to collide_connected the neighbours pair up
    rev = tst.joints.revolute
    open_st = dataclasses.replace(tst, joints=dataclasses.replace(
        tst.joints, revolute=dataclasses.replace(
            rev, collide_connected=torch.ones_like(rev.collide_connected))))
    from box2d_mt_tpu_torch.ops import broadphase
    g_a, _, _ = broadphase.find_pairs(open_st, tst.contacts.capacity)
    assert int((g_a >= 0).sum()) >= int((f_a >= 0).sum()) + 5


_GOLDENS = {
    "revolute_240": (lambda: tscenes.revolute_pendulum(device="cpu"), 2, 5e-3),
    "prismatic_240": (lambda: tscenes.prismatic_slide(device="cpu"), 2, 5e-3),
    "weld_240": (lambda: tscenes.weld_pendulum(device="cpu"), 3, 2e-2),
    "weldsoft_240": (lambda: tscenes.weld_pendulum(soft=True, device="cpu"), 3, 2e-2),
}
# the capacities of the largest golden scene: every golden is frozen with
# them, so that the four roll as one batch of worlds; the empty slots take
# no part (each world's worst error equals its roll alone)
_GOLDEN_CAPACITY = dict(body_capacity=4, fixture_capacity=2, contact_capacity=64,
                        joint_capacity={"revolute": 1, "prismatic": 1, "weld": 1})


@pytest.fixture(scope="module")
def golden_worst():
    """Each golden's worst position/angle error over its 240 steps against
    the C++ trace (bodies listed in reverse creation order), and whether
    every step was free of color and pair overflow."""
    freeze = tworld.WorldBuilder.freeze
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tworld.WorldBuilder, "freeze",
                   lambda self, **kw: freeze(self, **_GOLDEN_CAPACITY, **kw))
        st = concat_worlds([build() for build, _, _ in _GOLDENS.values()])
    refs = [[json.loads(line) for line in open(GOLDEN / f"{name}.jsonl")]
            for name in _GOLDENS]
    worst, clean = [0.0] * len(_GOLDENS), True
    for i in range(240):
        st, ev = tworld.step_batched(st, 1 / 60, velocity_iterations=8, position_iterations=3)
        p, a = st.bodies.xf_p.numpy(), st.bodies.a.numpy()
        for w, ((_, n_bodies, _), ref) in enumerate(zip(_GOLDENS.values(), refs)):
            for j, rb in enumerate(ref[i]["bodies"]):
                k = n_bodies - 1 - j
                worst[w] = max(worst[w], abs(p[w, k, 0] - rb[0]), abs(p[w, k, 1] - rb[1]),
                               abs(a[w, k] - rb[2]))
        clean &= int(ev.color_overflow.max()) == 0 and int(ev.pair_overflow.max()) == 0
    return {name: (worst[w], clean) for w, name in enumerate(_GOLDENS)}


@pytest.mark.parametrize("golden", list(_GOLDENS))
def test_port_meets_cpp_golden(golden_worst, golden):
    """240 steps against the C++ trace, at the JAX package's own bound for
    the scene."""
    worst, clean = golden_worst[golden]
    assert clean
    assert worst < _GOLDENS[golden][2]
