"""Circle shapes, chain shapes and sensors in the port, on the CPU.

  * `distance.test_overlap` (b2TestOverlap, the sensors' touch test)
    against the JAX package's on seeded lanes of circle-circle,
    polygon-circle, edge-circle and polygon-polygon pairs: the verdicts
    are equal except on lanes whose distance lies within 1e-6 of the
    threshold;
  * one padded batch of worlds against Box2D's C++ goldens, at the bounds
    of the JAX package's own tests (tests/test_step.py:78-97,
    tests/test_golden_zoo.py:338-355, tests/test_callbacks.py):
    distance_pendulum (a circle on a distance joint), edge_test (a circle
    and a box across ghost-connected edges), chain_problem (a bullet box
    onto a chain corner) and the sensor scene (a ball falling through a
    box sensor), each cut at the last step its assertion reads; the
    sensor's begin and end steps equal sensor_180.jsonl's. falling_circle's
    golden was recorded at 6 velocity and 2 position iterations, so it
    rolls alone at those;
  * the whole step of one scene with a circle, polygons, a chain, a
    sensor and a revolute joint, built with both packages' builders, 2
    worlds, 40 steps with continuous collision on, against the JAX step:
    c and a to 2e-5, v and w to 1e-4, awake, touching and the begin/end
    events equal; and on the state before the sensor's first touch, the
    collide phase and the touch phase of both packages: a sensor pair
    touches when it overlaps, keeps no manifold point, wakes nobody and
    is never solved.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from box2d_mt_tpu import settings as jsettings
from box2d_mt_tpu import shapes as jshapes
from box2d_mt_tpu import world as jworld
from box2d_mt_tpu.ops import distance as jdistance
from box2d_mt_tpu.parallel.sharding import replicate_state
from box2d_mt_tpu_torch import settings as tsettings
from box2d_mt_tpu_torch import shapes as tshapes
from box2d_mt_tpu_torch import world as tworld
from box2d_mt_tpu_torch.math2d import rot_from_angle
from box2d_mt_tpu_torch.models import scenes as tscenes
from box2d_mt_tpu_torch.ops import distance as tdistance
from box2d_mt_tpu_torch.ops.sync import HostSyncs
from box2d_mt_tpu_torch.state import concat_worlds, replicate, state_from_numpy, to_numpy

from conftest import GOLDEN

DT = 1.0 / 60.0


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """These tensors are a few worlds wide: PyTorch's intra-op threads cost
    more than they give, and workers running side by side share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# test_overlap
# ---------------------------------------------------------------------------

def _proxy(kind, rng, n):
    """n proxies of one kind as (verts (n, 8, 2), counts, radii)."""
    verts = np.zeros((n, 8, 2), np.float32)
    if kind == "circle":
        verts[:, 0] = rng.uniform(-0.3, 0.3, (n, 2))
        return verts, np.ones(n, np.int32), rng.uniform(0.1, 0.8, n).astype(np.float32)
    if kind == "edge":
        verts[:, 0] = rng.uniform(-1.0, 0.0, (n, 2))
        verts[:, 1] = rng.uniform(0.0, 1.0, (n, 2))
        return verts, np.full(n, 2, np.int32), np.full(n, tsettings.POLYGON_RADIUS, np.float32)
    # convex polygons: 3-8 vertices on an ellipse, counter-clockwise
    counts = rng.integers(3, 9, n)
    for i, m in enumerate(counts):
        ang = np.sort(rng.uniform(0.0, 2.0 * np.pi, m))
        rx, ry = rng.uniform(0.2, 0.9, 2)
        verts[i, :m] = np.stack([rx * np.cos(ang), ry * np.sin(ang)], -1)
    return verts, counts.astype(np.int32), np.full(n, tsettings.POLYGON_RADIUS, np.float32)


def test_overlap_matches_jax():
    """Sensor verdicts of both packages on 4 x 500 seeded lanes, each pair
    placed so that about half overlap."""
    rng = np.random.default_rng(21)
    n = 500
    pairs = [("circle", "circle"), ("polygon", "circle"), ("edge", "circle"),
             ("polygon", "polygon")]
    cols = [[] for _ in range(6)]
    for ka, kb in pairs:
        for col, x in zip(cols, (*_proxy(ka, rng, n), *_proxy(kb, rng, n))):
            col.append(x)
    va, ca, ra, vb, cb, rb = (np.concatenate(c) for c in cols)
    total = len(pairs) * n
    xa = np.stack([rng.uniform(-0.5, 0.5, total), rng.uniform(-0.5, 0.5, total),
                   rng.uniform(-np.pi, np.pi, total)], -1).astype(np.float32)
    # B at a random bearing from A, out to about twice the reach of the pair
    reach = np.repeat([0.9, 1.1, 0.9, 1.2], n)
    bearing = rng.uniform(-np.pi, np.pi, total)
    dist = rng.uniform(0.0, 2.0, total) * reach
    xb = np.stack([xa[:, 0] + dist * np.cos(bearing), xa[:, 1] + dist * np.sin(bearing),
                   rng.uniform(-np.pi, np.pi, total)], -1).astype(np.float32)

    jrot = lambda x: jnp.stack([jnp.sin(x[:, 2]), jnp.cos(x[:, 2])], -1)
    want = np.asarray(jax.jit(jax.vmap(jdistance.test_overlap))(
        va, ca, ra, xa[:, :2], jrot(jnp.asarray(xa)),
        vb, cb, rb, xb[:, :2], jrot(jnp.asarray(xb))))
    t = torch.from_numpy
    targs = (t(va), t(ca), t(ra), t(xa[:, :2]), rot_from_angle(t(xa[:, 2])),
             t(vb), t(cb), t(rb), t(xb[:, :2]), rot_from_angle(t(xb[:, 2])))
    got = tdistance.test_overlap(*targs).numpy()
    d = tdistance.gjk_distance(*targs, use_radii=True)[2].numpy()
    near = np.abs(d - 10.0 * tdistance.EPS) < 1e-6
    assert near.sum() <= total // 100
    np.testing.assert_array_equal(got[~near], want[~near])
    for k in range(len(pairs)):
        lanes = slice(k * n, (k + 1) * n)
        assert 0.2 * n < got[lanes].sum() < 0.8 * n, pairs[k]


# ---------------------------------------------------------------------------
# the C++ goldens, one padded batch
# ---------------------------------------------------------------------------

# scene: (golden file, bodies in the golden (None: events only), steps the
# bounds read)
_GOLDENS = {
    "distance_pendulum": ("distance_240", 2, 240),
    "edge_test": ("edge_test_120", 3, 120),
    "chain_problem": ("chain_problem_180", 2, 180),
    "sensor_drop": ("sensor_180", None, 180),
}
# the capacities of the largest scene, so that the four share a batch
_CAPACITY = dict(body_capacity=8, fixture_capacity=8, contact_capacity=64,
                 joint_capacity={"distance": 1})


def _load(name):
    return [json.loads(line) for line in open(GOLDEN / f"{name}.jsonl")]


def _errors(p, a, ref, n_bodies, w=0):
    """Worst position/angle error of world w against one golden record
    (bodies listed in reverse creation order)."""
    return max(max(abs(p[w, n_bodies - 1 - j, 0] - rb[0]), abs(p[w, n_bodies - 1 - j, 1] - rb[1]),
                   abs(a[w, n_bodies - 1 - j] - rb[2]))
               for j, rb in enumerate(ref["bodies"]))


@pytest.fixture(scope="module")
def golden_batch():
    """Per scene: its errors over the steps its bounds read, whether those
    steps were free of color overflow, and the sensor's begin and end
    steps and the ball's height at step 179."""
    st = concat_worlds([getattr(tscenes, name)(device="cpu", **_CAPACITY)
                        for name in _GOLDENS])
    specs = list(_GOLDENS.values())
    refs = [_load(spec[0]) for spec in specs]
    errs = [[] for _ in specs]
    clean = [True] * len(specs)
    events = {"begin": [], "end": []}
    sensor = list(_GOLDENS).index("sensor_drop")
    for i in range(max(spec[2] for spec in specs)):
        st, ev = tworld.step_batched(st, DT, velocity_iterations=8, position_iterations=3)
        p, a = st.bodies.xf_p.numpy(), st.bodies.a.numpy()
        overflow = ev.color_overflow.numpy()
        for w, ((_, n_bodies, steps), ref) in enumerate(zip(specs, refs)):
            if i >= steps:
                continue
            clean[w] &= int(overflow[w]) == 0
            if n_bodies is not None:
                errs[w].append(_errors(p, a, ref[i], n_bodies, w))
        # the full begin set: begin_touch on the table's slot basis and the
        # TOI-created touches on the refreshed basis
        if bool(ev.begin_touch[sensor].any() | ev.toi_begin[sensor].any()):
            events["begin"].append(i)
        if bool(ev.end_touch[sensor].any()):
            events["end"].append(i)
        if i == _GOLDENS["sensor_drop"][2] - 1:
            ball_y = float(p[sensor, 2, 1])
    out = {name: (np.asarray(errs[w]), clean[w]) for w, name in enumerate(_GOLDENS)}
    out["sensor_events"] = events, ball_y
    # falling_circle's golden: 6 velocity and 2 position iterations
    st = tscenes.falling_circle(device="cpu")
    ref = _load("circle_120")
    errs, clean = [], True
    for i in range(120):
        st, ev = tworld.step_batched(st, DT, velocity_iterations=6, position_iterations=2)
        errs.append(_errors(st.bodies.xf_p.numpy(), st.bodies.a.numpy(), ref[i], 2))
        clean &= int(ev.color_overflow[0]) == 0
    out["falling_circle"] = (np.asarray(errs), clean)
    return out


# the JAX package's bounds on the worst error and the last step's
@pytest.mark.parametrize("scene,worst,last", [
    ("falling_circle", 0.5, 0.2), ("distance_pendulum", 5e-3, None),
    ("edge_test", 5e-3, 1e-4), ("chain_problem", 5e-3, 1e-4)])
def test_port_meets_golden(golden_batch, scene, worst, last):
    errs, clean = golden_batch[scene]
    print(f"{scene}: worst error {errs.max():.3g}, last step {errs[-1]:.3g}")
    assert clean
    assert errs.max() < worst
    assert last is None or errs[-1] < last


def test_sensor_events_match_golden(golden_batch):
    """The ball enters and leaves the box sensor at the reference's steps,
    and falls through it to rest on the ground."""
    (events, ball_y), ref = golden_batch["sensor_events"], _load("sensor_180")
    assert events["begin"] == [r["step"] for r in ref if r.get("ev") == "begin"]
    assert events["end"] == [r["step"] for r in ref if r.get("ev") == "end"]
    final = [r for r in ref if "final" in r][0]["final"]
    assert abs(ball_y - final[1]) < 5e-3
    assert golden_batch["sensor_drop"][1]


# ---------------------------------------------------------------------------
# the whole step against the JAX package
# ---------------------------------------------------------------------------

def _mixed_scene(world, shapes, settings, **freeze_kw):
    """A chain ground with explicit ghosts; a ball dropped through a box
    sensor onto it; a box on a revolute joint that swings down into a
    resting circle; a small circle dropped on a larger one; a tilted box
    landing on the chain's slope."""
    dyn = settings.DYNAMIC_BODY
    wb = world.WorldBuilder(gravity=(0.0, -10.0))
    ground = wb.create_body()
    wb.create_fixture(ground, shapes.Chain(
        [(-10.0, 1.0), (-5.0, 0.0), (5.0, 0.0), (10.0, 1.0)],
        prev_vertex=(-12.0, 3.0), next_vertex=(12.0, 3.0)))
    gate = wb.create_body(position=(-3.0, 1.5))
    wb.create_fixture(gate, shapes.Polygon.box(0.6, 0.4), is_sensor=True)
    ball = wb.create_body(body_type=dyn, position=(-3.0, 2.8), linear_velocity=(0.0, -3.0))
    wb.create_fixture(ball, shapes.Circle(0.3), density=1.0)
    arm = wb.create_body(body_type=dyn, position=(3.0, 2.0))
    wb.create_fixture(arm, shapes.Polygon.box(0.5, 0.1), density=2.0)
    wb.create_revolute_joint(ground, arm, (2.5, 2.0))
    for pos, r, v in (((2.5, 0.61), 0.6, 0.0), ((6.0, 0.51), 0.5, 0.0),
                      ((6.0, 1.6), 0.25, -2.0)):
        b = wb.create_body(body_type=dyn, position=pos, linear_velocity=(0.0, v))
        wb.create_fixture(b, shapes.Circle(r), density=1.0)
    box = wb.create_body(body_type=dyn, position=(-6.5, 1.2), angle=0.2)
    wb.create_fixture(box, shapes.Polygon.box(0.4, 0.3), density=1.0, friction=0.4)
    return wb.freeze(**freeze_kw)


_EVENTS = ("begin_touch", "end_touch", "toi_begin")


@pytest.fixture(scope="module")
def mixed_run():
    """Both packages step the same two worlds (the second with velocities
    perturbed from a numpy seed) 40 times; one JAX compile."""
    jscene = _mixed_scene(jworld, jshapes, jsettings)
    tscene = _mixed_scene(tworld, tshapes, tsettings, device="cpu")
    kinds = jworld.possible_kinds(jscene)
    assert kinds == tworld.possible_kinds(tscene)
    rng = np.random.default_rng(5)
    dv = rng.uniform(-0.5, 0.5, jscene.bodies.v.shape).astype(np.float32)
    dv[np.asarray(jscene.bodies.body_type) != 2] = 0.0
    jst = replicate_state(jscene, 2)
    jst = dataclasses.replace(jst, bodies=dataclasses.replace(
        jst.bodies, v=jst.bodies.v.at[1].add(jnp.asarray(dv))))
    tst = replicate(tscene, 2)
    tv = tst.bodies.v.clone()
    tv[1] += torch.from_numpy(dv)
    tst = dataclasses.replace(tst, bodies=dataclasses.replace(tst.bodies, v=tv))

    jstep = jax.jit(lambda s: jworld.step_batched(s, jnp.float32(DT), kinds=kinds))
    steps = []
    for _ in range(40):
        jst, jev = jstep(jst)
        tst, tev = tworld.step_batched(tst, DT, kinds=kinds)
        steps.append((jax.tree.map(np.asarray, jst), to_numpy(tst),
                      {k: np.asarray(getattr(jev, k)) for k in _EVENTS},
                      {k: getattr(tev, k).numpy() for k in _EVENTS}))
    return jscene, tscene, steps, kinds


def test_mixed_scene_builders_agree(mixed_run):
    jscene, tscene, _, _ = mixed_run
    jn, tn = jax.tree.map(np.asarray, jscene), to_numpy(tscene)
    for grp in ("bodies", "fixtures", "contacts"):
        for f in dataclasses.fields(getattr(tn, grp)):
            assert np.array_equal(getattr(getattr(tn, grp), f.name)[0],
                                  getattr(getattr(jn, grp), f.name)), f"{grp}.{f.name}"
    assert np.array_equal(tn.joints.revolute.local_anchor_a[0],
                          jn.joints.revolute.local_anchor_a)
    fx = tn.fixtures
    assert fx.shape_type[0, :3].tolist() == [tsettings.SHAPE_EDGE] * 3   # the chain
    assert fx.ghosts[0, :3].all() and fx.is_sensor[0].sum() == 1


def test_mixed_scene_step_matches_jax(mixed_run):
    """Every step: c, a to 2e-5; v, w to 1e-4; awake, the pair table,
    touch flags and the begin/end events equal. The roll passes through
    sensor, circle, polygon-circle, edge-circle and edge-polygon touches."""
    seen = set()
    sensor_events = 0
    before = to_numpy(replicate(mixed_run[1], 2))
    for i, (j, t, jev, tev) in enumerate(mixed_run[2]):
        jb, tb = j.bodies, t.bodies
        np.testing.assert_allclose(tb.c, jb.c, rtol=0, atol=2e-5, err_msg=f"c @{i}")
        np.testing.assert_allclose(tb.a, jb.a, rtol=0, atol=2e-5, err_msg=f"a @{i}")
        np.testing.assert_allclose(tb.v, jb.v, rtol=0, atol=1e-4, err_msg=f"v @{i}")
        np.testing.assert_allclose(tb.w, jb.w, rtol=0, atol=1e-4, err_msg=f"w @{i}")
        np.testing.assert_array_equal(tb.awake, jb.awake, err_msg=f"awake @{i}")
        for name in ("f_a", "f_b", "touching"):
            np.testing.assert_array_equal(getattr(t.contacts, name),
                                          getattr(j.contacts, name), err_msg=f"{name} @{i}")
        for name in _EVENTS:
            np.testing.assert_array_equal(tev[name], jev[name], err_msg=f"{name} @{i}")
        fa = np.clip(t.contacts.f_a, 0, None)
        fb = np.clip(t.contacts.f_b, 0, None)
        st = t.fixtures.shape_type
        pairs = np.stack([np.take_along_axis(st, fa, 1), np.take_along_axis(st, fb, 1)], -1)
        seen.update(map(tuple, pairs[t.contacts.touching & ~_sensor_lanes(t)].tolist()))
        # events index the table the step started from
        sensor_events += int((_sensor_lanes(before)
                              & (tev["begin_touch"] | tev["end_touch"])).sum())
        before = t
    c, e, p = tsettings.SHAPE_CIRCLE, tsettings.SHAPE_EDGE, tsettings.SHAPE_POLYGON
    assert {(c, c), (p, c), (e, c), (e, p)} <= seen
    assert sensor_events >= 4                       # in and out, in both worlds


def _sensor_lanes(st):
    """(W, C) existing pairs with a sensor fixture, of a numpy state."""
    fa, fb = np.clip(st.contacts.f_a, 0, None), np.clip(st.contacts.f_b, 0, None)
    sensor = (np.take_along_axis(st.fixtures.is_sensor, fa, 1)
              | np.take_along_axis(st.fixtures.is_sensor, fb, 1))
    return sensor & (st.contacts.f_a >= 0)


def test_sensor_touch_phase_matches_jax(mixed_run):
    """The step before the sensor's first begin event, through both
    packages' collide and touch phases from the same state."""
    _, _, steps, kinds = mixed_run
    # events index the table the step started from: the previous state's
    first = next(i for i in range(1, len(steps))
                 if (steps[i][3]["begin_touch"] & _sensor_lanes(steps[i - 1][1])).any())

    @jax.jit
    def phases(st):
        man, sensor, touch, ba, bb = jworld._collide_b(st, kinds)
        enabled = jnp.ones(st.contacts.f_a.shape, bool)
        return sensor, jax.vmap(jworld._pre_touch)(st, man, sensor, touch, enabled, ba, bb)

    sensor, jpt = phases(jax.tree.map(jnp.asarray, steps[first - 1][0]))
    tst = state_from_numpy(steps[first - 1][0], device="cpu")
    kind, tsensor = tworld._pair_kinds(tst)
    table = tworld._Table(kinds, kind, tsensor, True)
    tman, ttouch, tba, tbb = tworld._collide_b(tst, table, HostSyncs())
    tpt = tworld._pre_touch(tst, tman, tsensor, ttouch, tba, tbb)
    lanes = _sensor_lanes(steps[first - 1][0])
    np.testing.assert_array_equal(tsensor.numpy(), np.asarray(sensor) & lanes)
    for name in ("touching", "m_count"):
        np.testing.assert_array_equal(getattr(tpt.contacts, name).numpy(),
                                      np.asarray(getattr(jpt.contacts, name)), err_msg=name)
    for name in ("solvable", "awake0", "begin_touch", "end_touch"):
        np.testing.assert_array_equal(getattr(tpt, name).numpy(),
                                      np.asarray(getattr(jpt, name)), err_msg=name)
    began = tpt.begin_touch.numpy() & lanes
    assert began.any() and not (tpt.solvable.numpy() & lanes).any()
    assert not tpt.contacts.m_count.numpy()[lanes].any()
