"""The port's own scene behaviours, held the way the JAX package's tests
hold JAX's: tests/test_scene_zoo.py:88-330 (the bounce order, the mass
ratio, the filter groups, the sensor zone, the ManyBodies variants, the
skier, the chain and edge scenes, collision processing, the sleeping
pyramids beside a spinning tumbler, the slider crank, shape editing) and
tests/test_sleep_parity.py (pyramid(10) and vertical_stack(10) fall
asleep; a sleeping island stays put beside an active body). The same
assertions and bounds as those tests.

The scenes that need no mutation between steps roll as one padded batch
(frozen with the largest capacities among them, by
tools/consistency_torch.padded_batch), each world leaving the batch when
its JAX test's roll ends; a world's trajectory does not depend on the
batch (tests/test_torch_tools.py holds that bit for bit). The skier is
teleported to the slope edge before the roll, as the JAX test does.
Collision processing and shape editing mutate between steps and roll
alone, as do the ManyBodies variants, whose worlds are larger.
"""

import importlib
import pathlib
import sys

import numpy as np
import pytest
import torch

from box2d_mt_tpu_torch import WorldBuilder, mutate, settings, shapes, world
from box2d_mt_tpu_torch.models import scenes
from box2d_mt_tpu_torch.ops import narrowphase as nph

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "tools"))
ct = importlib.import_module("consistency_torch")

from test_torch_goldens_more import windowed_roll  # noqa: E402

DT = 1.0 / 60.0


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """These tensors are a few worlds wide: PyTorch's intra-op threads cost
    more than they give, and workers running side by side share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arg(fn, *a):
    return lambda device="cuda", **cap: fn(*a, device=device, **cap)


def _skier(device="cuda", **cap):
    st = scenes.skier(device=device, **cap)
    return mutate.set_transform(st, 1, (-0.7, float(st.bodies.xf_p[0, 1, 1])), 0.0)


def _sleep_island(device="cuda", **cap):
    """tests/test_sleep_parity.py's world: three stacked boxes that settle
    and sleep, and a far ball with restitution 1 that bounces forever."""
    wb = WorldBuilder(gravity=(0.0, -10.0))
    ground = wb.create_body()
    wb.create_fixture(ground, shapes.Edge((-40.0, 0.0), (40.0, 0.0)))
    for i in range(3):
        b = wb.create_body(body_type=settings.DYNAMIC_BODY, position=(0.0, 0.5 + 1.01 * i))
        wb.create_fixture(b, shapes.Polygon.box(0.5, 0.5), density=1.0, friction=0.5)
    ball = wb.create_body(body_type=settings.DYNAMIC_BODY, position=(20.0, 5.0))
    wb.create_fixture(ball, shapes.Circle(0.5), density=1.0, restitution=1.0)
    return wb.freeze(device=device, **cap)


# name: (builder, steps of its JAX test's roll)
BATCH = {
    "varying_restitution": (scenes.varying_restitution, 300),
    "heavy_on_light": (scenes.heavy_on_light, 180),
    "collision_filtering": (scenes.collision_filtering, 120),
    "sensor_zone": (scenes.sensor_zone, 90),
    "skier": (_skier, 180),
    "chain_problem": (scenes.chain_problem, 180),
    "edge_test": (scenes.edge_test, 90),
    "sleep_collide_perf": (_arg(scenes.sleep_collide_perf, 2, 6, 1, 12), 300),
    "basic_slider_crank": (scenes.basic_slider_crank, 120),
    "pyramid10": (_arg(scenes.pyramid, 10), 200),
    "vertical_stack10": (_arg(scenes.vertical_stack, 10), 200),
    "sleep_island": (_sleep_island, 300),
}


@pytest.fixture(scope="module")
def batch_roll():
    """{name: per-step records of its world}: c, a, v, w, awake and body
    type after each step, the step's color overflow, and the fixtures of
    its begin and of its begin-or-end events."""
    names = list(BATCH)
    st, _ = ct.padded_batch([(n, BATCH[n][0], 1) for n in names], "cpu")
    out = {n: [] for n in names}
    for _, alive, st, ev in windowed_roll(st, [BATCH[n][1] for n in names]):
        b = st.bodies
        rec = dict(c=b.c.numpy().copy(), a=b.a.numpy().copy(), v=b.v.numpy().copy(),
                   w=b.w.numpy().copy(), awake=b.awake.numpy().copy(),
                   body_type=b.body_type.numpy().copy(),
                   overflow=ev.color_overflow.numpy().copy())
        beg, end = ev.begin_touch.numpy(), ev.end_touch.numpy()
        fa, fb = ev.f_a.numpy(), ev.f_b.numpy()
        for r, w in enumerate(alive):
            step = {k: v[r] for k, v in rec.items()}
            step["begin_fixtures"] = set(fa[r][beg[r]]) | set(fb[r][beg[r]])
            touched = beg[r] | end[r]
            step["touch_fixtures"] = set(fa[r][touched]) | set(fb[r][touched])
            out[names[w]].append(step)
    return out


def test_varying_restitution_orders_bounce_height(batch_roll):
    """Higher restitution bounces higher (VaryingRestitution.h)."""
    peak = np.zeros(7)
    bounced = np.zeros(7, bool)
    for s in batch_roll["varying_restitution"]:
        y, vy = s["c"][1:8, 1], s["v"][1:8, 1]
        bounced |= vy > 0.1
        peak = np.where(bounced, np.maximum(peak, y), peak)
    assert peak[0] < 3.0, peak
    assert peak[6] > 14.0, peak
    assert peak[3] < peak[5] < peak[6], peak


def test_heavy_on_light_supports_mass_ratio(batch_roll):
    """The 100x-mass circle rests on the light one (HeavyOnLight.h)."""
    c = batch_roll["heavy_on_light"][-1]["c"]
    assert c[1, 1] > 0.3, c[1]
    assert c[2, 1] > c[1, 1], c


def test_collision_filtering_groups(batch_roll):
    """CollisionFiltering.h: no overflow, finite, everything settles above
    the ground."""
    roll = batch_roll["collision_filtering"]
    assert sum(int(s["overflow"]) for s in roll) == 0
    exists = roll[-1]["body_type"] >= 0
    c = roll[-1]["c"][exists]
    assert np.isfinite(c).all()
    assert (c[:, 1] > -1.0).all()


def test_sensor_zone_emits_begin_events(batch_roll):
    """Falling circles cross the big sensor circle (fixture 1): begin
    events, and no collision response (SensorTest.h)."""
    roll = batch_roll["sensor_zone"]
    assert any(1 in s["begin_fixtures"] for s in roll), "no sensor begin event observed"
    assert (roll[-1]["c"][1:8, 1] < 9.0).all(), roll[-1]["c"][1:8]


def test_skier_no_collision_jerk(batch_roll):
    """Skier.h: crossing the ghost-connected slope joints does not kick the
    frictionless skier up, and it keeps descending."""
    roll = batch_roll["skier"]
    assert max(float(s["v"][1, 1]) for s in roll) < 0.05
    c = roll[-1]["c"][1]
    assert c[0] > 0.5, c
    assert np.isfinite(c).all()


def test_chain_problem_rests_on_chain(batch_roll):
    """chainProblem.h: the tall bullet box rests on the chain floor."""
    s = batch_roll["chain_problem"][-1]
    c, v = s["c"][1], s["v"][1]
    assert c[1] > 0.4, c
    assert abs(v[0]) < 0.5 and abs(v[1]) < 0.5, v
    assert np.isfinite(c).all()


def test_edge_test_settles_on_terrain(batch_roll):
    """EdgeTest.h: the circle and the box rest on the terrain."""
    c = batch_roll["edge_test"][-1]["c"]
    assert abs(c[1, 1] - 0.5) < 0.1, c[1]
    assert abs(c[2, 1] - 0.5) < 0.1, c[2]


def test_sleep_collide_perf_pyramids_sleep_tumbler_spins(batch_roll):
    """SleepCollidePerf.h: the pyramids' 42 boxes sleep while the no-sleep
    tumbler keeps spinning."""
    s = batch_roll["sleep_collide_perf"][-1]
    n_pyr = 42
    assert (~s["awake"][1:1 + n_pyr]).sum() == n_pyr
    assert s["awake"][1 + n_pyr], "tumbler fell asleep"
    assert abs(float(s["w"][1 + n_pyr])) > 0.01


def test_basic_slider_crank_piston_guided(batch_roll):
    """BasicSliderCrank.h: the prismatic guide keeps the piston on its line
    while the crank sags."""
    s = batch_roll["basic_slider_crank"][-1]
    c, a = s["c"], s["a"]
    assert abs(c[3, 1] - 20.0) < 0.05, c[3]
    assert abs(a[3]) < 1e-3
    assert c[1, 1] < 20.0 - 0.5, c[1]
    assert np.isfinite(c[s["body_type"] >= 0]).all()


def _slept_at(roll):
    """The first step after which no dynamic body is awake, with no color
    overflow before it."""
    for i, s in enumerate(roll):
        assert int(s["overflow"]) == 0, f"color overflow at step {i}"
        if not (s["awake"] & (s["body_type"] == settings.DYNAMIC_BODY)).any():
            return i, s
    return None, roll[-1]


def test_pyramid10_sleeps(batch_roll):
    slept_at, s = _slept_at(batch_roll["pyramid10"])
    assert slept_at is not None, "pyramid(10) never slept in 200 steps"
    assert float(np.abs(s["v"]).max()) == 0.0
    assert float(np.abs(s["w"]).max()) == 0.0
    apex = s["c"][55]
    assert abs(apex[0] - (-1.9375)) < 0.35, apex
    assert abs(apex[1] - 9.6) < 0.35, apex


def test_vertical_stack10_sleeps(batch_roll):
    slept_at, s = _slept_at(batch_roll["vertical_stack10"])
    assert slept_at is not None, "vertical_stack(10) never slept"
    c = s["c"]
    assert np.all(np.abs(c[1:11, 0]) < 0.2)
    assert np.all(np.diff(c[1:11, 1]) > 0.8)


def test_sleeping_island_stays_put(batch_roll):
    """SleepCollideTest analog: the stack sleeps by step 240 while the ball
    bounces; over the next 60 steps the stack neither moves, wakes nor
    takes part in a begin or end event."""
    roll = batch_roll["sleep_island"]
    settled = roll[239]
    assert not settled["awake"][1:4].any(), "stack should be asleep"
    assert settled["awake"][4], "ball should still bounce"
    for s in roll[240:]:
        assert not s["touch_fixtures"] & {1, 2, 3}
        assert not s["awake"][1:4].any()
    np.testing.assert_array_equal(roll[-1]["c"][1:4], settled["c"][1:4])


@pytest.mark.parametrize("variant", [1, 2, 3, 4, 5, 6])
def test_many_bodies_variants(variant):
    """ManyBodies1-6 (ManyBodies.h:335-427) with the UpdateFloaterTask
    analog between steps: finite, inside the border, within the pair and
    color budgets."""
    st, aux = scenes.many_bodies_variant(variant, device="cpu")
    kinds = world.possible_kinds(st)
    for _ in range(12):
        st = scenes.floater_drive(st, aux, DT)
        st, ev = world.step(st, DT, kinds=kinds)
        assert int(ev.color_overflow.sum()) == 0
        assert int(ev.pair_overflow.sum()) == 0
    live = st.bodies.body_type[0] >= 0
    c = st.bodies.c[0][live]
    assert torch.isfinite(c).all()
    border = {1: 150.0, 2: 100.0, 3: 150.0, 4: 60.0, 5: 60.0, 6: 40.0}[variant]
    assert float(c.abs().max()) < border + 10.0


def test_collision_processing_destroys_lighter_of_touching():
    """CollisionProcessing.h: each step the lighter body of every touching
    dynamic pair is destroyed (at most 6 a step); the rest keep
    simulating."""
    st = scenes.collision_processing(7, device="cpu")
    kinds = world.possible_kinds(st)
    removed = set()
    for _ in range(120):
        st, _ = world.step(st, DT, kinds=kinds)
        touching = st.contacts.touching[0].numpy()
        f_a, f_b = st.contacts.f_a[0].numpy(), st.contacts.f_b[0].numpy()
        fx_body = st.fixtures.body[0].numpy()
        inv_mass = st.bodies.inv_mass[0].numpy()
        nuke = []
        for i in np.nonzero(touching)[0]:
            ba, bb = int(fx_body[f_a[i]]), int(fx_body[f_b[i]])
            if ba in removed or bb in removed:
                continue
            ma = 1.0 / inv_mass[ba] if inv_mass[ba] > 0 else 0.0
            mb = 1.0 / inv_mass[bb] if inv_mass[bb] > 0 else 0.0
            if ma > 0.0 and mb > 0.0:
                nuke.append(ba if mb > ma else bb)
        for b in sorted(set(nuke))[:6]:
            st = mutate.remove_body(st, b)
            removed.add(b)
    exists = (st.bodies.body_type[0] >= 0).numpy()
    assert len(removed) >= 1, "no touching dynamic pair ever destroyed"
    assert not exists[sorted(removed)].any()
    assert np.isfinite(st.bodies.c[0].numpy()[exists]).all()


def test_shape_editing_add_remove_fixture():
    """ShapeEditing.h: a circle fixture attached to the resting box makes
    the compound rest higher (it tilts onto the offset circle); detached,
    the box settles back; with the ground a sensor it falls through."""
    st = scenes.shape_editing(device="cpu")
    kinds = tuple(sorted(set(world.possible_kinds(st))
                         | {nph.KIND_EDGE_CIRCLE, nph.KIND_POLYGON_CIRCLE}))

    def settle(st, n=150):
        for _ in range(n):
            st, _ = world.step(st, DT, kinds=kinds)
        return st

    st = settle(st)
    y_bare = float(st.bodies.c[0, 1, 1])
    assert abs(y_bare - 4.0) < 0.05, y_bare
    st, fix2 = mutate.add_fixture(st, 1, shapes.Circle(3.0, (0.5, -4.0)), density=10.0)
    assert int(fix2[0]) >= 0
    st = mutate.set_awake(st, 1, True)
    st = settle(st)
    y_comp = float(st.bodies.c[0, 1, 1])
    assert y_comp > y_bare + 0.5, (y_bare, y_comp)
    st = mutate.remove_fixture(st, fix2)
    st = mutate.set_awake(st, 1, True)
    st = settle(st)
    y_back = float(st.bodies.c[0, 1, 1])
    assert abs(y_back - y_bare) < 0.1, (y_bare, y_back)
    st = mutate.set_sensor(st, 0, True)          # the ground becomes a sensor
    st = mutate.set_awake(st, 1, True)
    st = settle(st, 60)
    assert float(st.bodies.c[0, 1, 1]) < y_bare - 2.0
