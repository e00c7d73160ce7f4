"""Scenes built with the port alone.

Same construction as `box2d_mt_tpu.models.scenes`, so the frozen states of
the two packages are equal field by field. States land on the card unless
the caller passes another `device` (the tests pass device="cpu"). Every
builder passes `WorldBuilder.freeze`'s capacities through, so that scenes
frozen with equal capacities share a batch (`state.concat_worlds`).
Scenes that reserve spare slots for `mutate` (breakable, shape_editing)
keep their JAX capacities unless the caller passes others."""

import dataclasses
import math
import random

import numpy as np
import torch

from .. import settings, shapes
from ..world import WorldBuilder


def hello_world(device="cuda", **capacity):
    """HelloWorld.cpp:28-81 — ground box + one falling dynamic box."""
    wb = WorldBuilder(gravity=(0.0, -10.0))
    ground = wb.create_body(position=(0.0, -10.0))
    wb.create_fixture(ground, shapes.Polygon.box(50.0, 10.0))
    body = wb.create_body(body_type=settings.DYNAMIC_BODY, position=(0.0, 4.0))
    wb.create_fixture(body, shapes.Polygon.box(1.0, 1.0), density=1.0,
                      friction=0.3)
    return wb.freeze(device=device, **capacity)


def pyramid(rows=10, device="cuda", **capacity):
    """Testbed/Tests/Pyramid.h — the classic stacking benchmark."""
    wb = WorldBuilder(gravity=(0.0, -10.0))
    ground = wb.create_body()
    wb.create_fixture(ground, shapes.Edge((-40.0, 0.0), (40.0, 0.0)))
    box = shapes.Polygon.box(0.5, 0.5)
    x = (-7.0, 0.75)
    dx = (0.5625, 1.25)
    dy = (1.125, 0.0)
    for i in range(rows):
        y = x
        for j in range(i, rows):
            b = wb.create_body(body_type=settings.DYNAMIC_BODY, position=y)
            wb.create_fixture(b, box, density=5.0)
            y = (y[0] + dy[0], y[1] + dy[1])
        x = (x[0] + dx[0], x[1] + dx[1])
    return wb.freeze(device=device, **capacity)


def revolute_pendulum(device="cuda", **capacity):
    """Golden scene: box swinging on a revolute joint (golden.cpp)."""
    wb = WorldBuilder(gravity=(0.0, -10.0))
    ground = wb.create_body()
    body = wb.create_body(body_type=settings.DYNAMIC_BODY, position=(3.0, 10.0))
    wb.create_fixture(body, shapes.Polygon.box(0.5, 0.5), density=5.0)
    wb.create_revolute_joint(ground, body, (0.0, 10.0))
    return wb.freeze(device=device, **capacity)


def prismatic_slide(device="cuda", **capacity):
    """Golden scene: motorized prismatic slider with limits (golden.cpp)."""
    wb = WorldBuilder(gravity=(0.0, -10.0))
    ground = wb.create_body()
    body = wb.create_body(body_type=settings.DYNAMIC_BODY,
                          position=(0.0, 10.0), angle=0.5)
    wb.create_fixture(body, shapes.Polygon.box(2.0, 0.5), density=5.0)
    n = math.sqrt(5.0)
    wb.create_prismatic_joint(
        ground, body, (0.0, 10.0), (2.0 / n, 1.0 / n),
        enable_motor=True, motor_speed=1.0, max_motor_force=100.0,
        enable_limit=True, lower_translation=-5.0, upper_translation=5.0)
    return wb.freeze(device=device, **capacity)


def tumbler(n_boxes=200, device="cuda", **capacity):
    """Testbed/Tests/Tumbler.h: a rotating container full of boxes, driven
    by a revolute motor on a dynamic container."""
    wb = WorldBuilder(gravity=(0.0, -10.0))
    ground = wb.create_body()
    container = wb.create_body(body_type=settings.DYNAMIC_BODY,
                               position=(0.0, 10.0), allow_sleep=False)
    box = shapes.Polygon.box
    wb.create_fixture(container, box(0.5, 10.0, (10.0, 0.0), 0.0), density=5.0)
    wb.create_fixture(container, box(0.5, 10.0, (-10.0, 0.0), 0.0), density=5.0)
    wb.create_fixture(container, box(10.0, 0.5, (0.0, 10.0), 0.0), density=5.0)
    wb.create_fixture(container, box(10.0, 0.5, (0.0, -10.0), 0.0), density=5.0)
    wb.create_revolute_joint(ground, container, (0.0, 10.0),
                             enable_motor=True, motor_speed=0.05 * 3.14159265,
                             max_motor_torque=1e8)
    rng = random.Random(42)
    for _ in range(n_boxes):
        b = wb.create_body(body_type=settings.DYNAMIC_BODY,
                           position=(rng.uniform(-5, 5), 10.0 + rng.uniform(-5, 5)))
        wb.create_fixture(b, box(0.125, 0.125), density=1.0)
    return wb.freeze(device=device, **capacity)


def weld_pendulum(soft=False, device="cuda", **capacity):
    """Golden scene: two boxes welded, swinging on a revolute (golden2.cpp)."""
    wb = WorldBuilder(gravity=(0.0, -10.0))
    ground = wb.create_body()
    b1 = wb.create_body(body_type=settings.DYNAMIC_BODY, position=(2.0, 8.0))
    wb.create_fixture(b1, shapes.Polygon.box(0.5, 0.5), density=5.0)
    b2 = wb.create_body(body_type=settings.DYNAMIC_BODY, position=(3.0, 8.0))
    wb.create_fixture(b2, shapes.Polygon.box(0.5, 0.5), density=5.0)
    wb.create_revolute_joint(ground, b1, (2.0, 9.0))
    if soft:
        wb.create_weld_joint(b1, b2, (2.5, 8.0), frequency=4.0,
                             damping_ratio=0.5)
    else:
        wb.create_weld_joint(b1, b2, (2.5, 8.0))
    return wb.freeze(device=device, **capacity)


def cantilever(n=8, device="cuda", **capacity):
    """Testbed/Tests/Cantilever.h: weld-joint beams: a rigid chain, a soft
    (5 Hz, 0.7 damping) chain, and a second rigid chain."""
    wb = WorldBuilder(gravity=(0.0, -10.0))
    ground = wb.create_body()
    wb.create_fixture(ground, shapes.Edge((-40.0, 0.0), (40.0, 0.0)))
    plank = shapes.Polygon.box(0.5, 0.125)
    prev = ground
    for i in range(n):
        b = wb.create_body(body_type=settings.DYNAMIC_BODY,
                           position=(-14.5 + 1.0 * i, 5.0))
        wb.create_fixture(b, plank, density=20.0)
        wb.create_weld_joint(prev, b, (-15.0 + 1.0 * i, 5.0))
        prev = b
    wide = shapes.Polygon.box(1.0, 0.125)
    prev = ground
    for i in range(3):
        b = wb.create_body(body_type=settings.DYNAMIC_BODY,
                           position=(-14.0 + 2.0 * i, 15.0))
        wb.create_fixture(b, wide, density=20.0)
        wb.create_weld_joint(prev, b, (-15.0 + 2.0 * i, 15.0),
                             frequency=5.0, damping_ratio=0.7)
        prev = b
    prev = ground
    for i in range(n):
        b = wb.create_body(body_type=settings.DYNAMIC_BODY,
                           position=(-4.5 + 1.0 * i, 5.0))
        wb.create_fixture(b, plank, density=20.0)
        wb.create_weld_joint(prev, b, (-5.0 + 1.0 * i, 5.0))
        prev = b
    return wb.freeze(device=device, **capacity)


def bullet_test(device="cuda", **capacity):
    """Testbed/Tests/BulletTest.h:26-67 — thin dynamic plank at (0, 4) with
    a dense 0.25-box bullet dropped at -50 m/s from (0.20352793, 10); the
    reference's canonical CCD regression (x pinned to its recorded seed)."""
    wb = WorldBuilder(gravity=(0.0, -10.0))
    ground = wb.create_body(position=(0.0, 0.0))
    wb.create_fixture(ground, shapes.Edge((-10.0, 0.0), (10.0, 0.0)))
    wb.create_fixture(ground, shapes.Polygon.box(0.2, 1.0, (0.5, 1.0), 0.0))
    plank = wb.create_body(body_type=settings.DYNAMIC_BODY, position=(0.0, 4.0))
    wb.create_fixture(plank, shapes.Polygon.box(2.0, 0.1), density=1.0)
    bullet = wb.create_body(body_type=settings.DYNAMIC_BODY,
                            position=(0.20352793, 10.0), bullet=True,
                            linear_velocity=(0.0, -50.0))
    wb.create_fixture(bullet, shapes.Polygon.box(0.25, 0.25), density=100.0)
    return wb.freeze(device=device, **capacity)


def continuous_test(angular_velocity=46.661274, device="cuda", **capacity):
    """Testbed/Tests/ContinuousTest.h:27-61 — spinning plank launched at
    -100 m/s onto an edge ground next to a vertical wall; non-bullet
    dynamic-vs-static CCD. omega defaults to the reference's recorded
    seed (ContinuousTest.h:57)."""
    wb = WorldBuilder(gravity=(0.0, -10.0))
    ground = wb.create_body(position=(0.0, 0.0))
    wb.create_fixture(ground, shapes.Edge((-10.0, 0.0), (10.0, 0.0)))
    wb.create_fixture(ground, shapes.Polygon.box(0.2, 1.0, (0.5, 1.0), 0.0))
    plank = wb.create_body(body_type=settings.DYNAMIC_BODY, position=(0.0, 20.0),
                           linear_velocity=(0.0, -100.0),
                           angular_velocity=angular_velocity)
    wb.create_fixture(plank, shapes.Polygon.box(2.0, 0.1), density=1.0)
    return wb.freeze(device=device, **capacity)


def bullet_on_stack(n=5, device="cuda", **capacity):
    """Mini-island CCD oracle (b2World.cpp:902-1001 StepSolveTOI): a bullet
    fired horizontally into the base of a vertical stack — the TOI sub-solve
    must pull the hit box's stack neighbors into the island or the box
    tunnels into them before the next full step."""
    wb = WorldBuilder(gravity=(0.0, -10.0))
    ground = wb.create_body()
    wb.create_fixture(ground, shapes.Edge((-40.0, 0.0), (40.0, 0.0)))
    for i in range(n):
        b = wb.create_body(body_type=settings.DYNAMIC_BODY,
                           position=(0.0, 0.502 + 1.01 * i))
        wb.create_fixture(b, shapes.Polygon.box(0.5, 0.5), density=1.0, friction=0.3)
    bullet = wb.create_body(body_type=settings.DYNAMIC_BODY, position=(-20.0, 1.0),
                            bullet=True, linear_velocity=(80.0, 0.0))
    wb.create_fixture(bullet, shapes.Polygon.box(0.25, 0.25), density=20.0)
    return wb.freeze(device=device, **capacity)


def chain_links(n=30, device="cuda", **capacity):
    """Testbed/Tests/Chain.h: n planks revolute-chained off the ground at
    y=25, swinging down under gravity."""
    wb = WorldBuilder(gravity=(0.0, -10.0))
    ground = wb.create_body()
    wb.create_fixture(ground, shapes.Edge((-40.0, 0.0), (40.0, 0.0)))
    plank = shapes.Polygon.box(0.6, 0.125)
    y, prev = 25.0, ground
    for i in range(n):
        b = wb.create_body(body_type=settings.DYNAMIC_BODY,
                           position=(0.5 + i, y))
        wb.create_fixture(b, plank, density=20.0, friction=0.2)
        wb.create_revolute_joint(prev, b, (float(i), y))
        prev = b
    return wb.freeze(device=device, **capacity)


# ---------------------------------------------------------------------------
# The rest of the zoo that the port steps: the JAX package's builders, in
# its order of definition, with their sources.
# ---------------------------------------------------------------------------

def falling_circle(device="cuda", **capacity):
    """Golden scene: restitution-heavy circle drop (tools golden.cpp)."""
    wb = WorldBuilder(gravity=(0.0, -10.0))
    ground = wb.create_body(position=(0.0, -10.0))
    wb.create_fixture(ground, shapes.Polygon.box(50.0, 10.0))
    body = wb.create_body(body_type=settings.DYNAMIC_BODY, position=(0.0, 4.0))
    wb.create_fixture(body, shapes.Circle(0.5), density=1.0, friction=0.3,
                      restitution=0.5)
    return wb.freeze(device=device, **capacity)


def vertical_stack(n=5, device="cuda", **capacity):
    """Testbed/Tests/VerticalStack.h — boxes stacked on an edge ground."""
    wb = WorldBuilder(gravity=(0.0, -10.0))
    ground = wb.create_body()
    wb.create_fixture(ground, shapes.Edge((-40.0, 0.0), (40.0, 0.0)))
    for i in range(n):
        b = wb.create_body(body_type=settings.DYNAMIC_BODY,
                           position=(0.0, 0.502 + 1.01 * i))
        wb.create_fixture(b, shapes.Polygon.box(0.5, 0.5), density=1.0,
                          friction=0.3)
    return wb.freeze(device=device, **capacity)


def distance_pendulum(device="cuda", **capacity):
    """Golden scene: circle on a rigid distance joint (golden.cpp)."""
    wb = WorldBuilder(gravity=(0.0, -10.0))
    ground = wb.create_body()
    body = wb.create_body(body_type=settings.DYNAMIC_BODY, position=(2.0, 8.0))
    wb.create_fixture(body, shapes.Circle(0.5), density=1.0)
    wb.create_distance_joint(ground, body, (0.0, 10.0), (2.0, 8.0))
    return wb.freeze(device=device, **capacity)


def dominos(device="cuda", **capacity):
    """Testbed/Tests/Dominos.h — platforms, a row of dominos, seesaw plate
    on a revolute, a swinging box, a 3-fixture cradle and small circles."""
    wb = WorldBuilder(gravity=(0.0, -10.0))
    box = shapes.Polygon.box
    b1 = wb.create_body()
    wb.create_fixture(b1, shapes.Edge((-40.0, 0.0), (40.0, 0.0)))
    shelf1 = wb.create_body(position=(-1.5, 10.0))
    wb.create_fixture(shelf1, box(6.0, 0.25))
    for i in range(10):
        d = wb.create_body(body_type=settings.DYNAMIC_BODY,
                           position=(-6.0 + 1.0 * i, 11.25))
        wb.create_fixture(d, box(0.1, 1.0), density=20.0, friction=0.1)
    shelf2 = wb.create_body(position=(1.0, 6.0))
    wb.create_fixture(shelf2, box(7.0, 0.25, (0.0, 0.0), 0.3))
    b2 = wb.create_body(position=(-7.0, 4.0))
    wb.create_fixture(b2, box(0.25, 1.5))
    b3 = wb.create_body(body_type=settings.DYNAMIC_BODY,
                        position=(-0.9, 1.0), angle=-0.15)
    wb.create_fixture(b3, box(6.0, 0.125), density=10.0)
    wb.create_revolute_joint(b1, b3, (-2.0, 1.0), collide_connected=True)
    b4 = wb.create_body(body_type=settings.DYNAMIC_BODY, position=(-10.0, 15.0))
    wb.create_fixture(b4, box(0.25, 0.25), density=10.0)
    wb.create_revolute_joint(b2, b4, (-7.0, 15.0))
    b5 = wb.create_body(body_type=settings.DYNAMIC_BODY, position=(6.5, 3.0))
    wb.create_fixture(b5, box(1.0, 0.1, (0.0, -0.9), 0.0), density=10.0,
                      friction=0.1)
    wb.create_fixture(b5, box(0.1, 1.0, (-0.9, 0.0), 0.0), density=10.0,
                      friction=0.1)
    wb.create_fixture(b5, box(0.1, 1.0, (0.9, 0.0), 0.0), density=10.0,
                      friction=0.1)
    wb.create_revolute_joint(b1, b5, (6.0, 2.0))
    b6 = wb.create_body(body_type=settings.DYNAMIC_BODY, position=(6.5, 4.1))
    wb.create_fixture(b6, box(1.0, 0.1), density=30.0)
    wb.create_revolute_joint(b5, b6, (7.5, 4.0))
    b7 = wb.create_body(body_type=settings.DYNAMIC_BODY, position=(7.4, 1.0))
    wb.create_fixture(b7, box(0.1, 1.0), density=10.0)
    # reference uses explicit local anchors (6,0)/(0,-1) — world points
    # below reproduce them given the build poses (b3 angle -0.15)
    c, s = math.cos(-0.15), math.sin(-0.15)
    wa = (-0.9 + c * 6.0, 1.0 + s * 6.0)
    wb_pt = (7.4, 0.0)
    wb.create_distance_joint(b3, b7, wa, wb_pt)
    for i in range(4):
        c_ = wb.create_body(body_type=settings.DYNAMIC_BODY,
                            position=(5.9 + 2.0 * 0.2 * i, 2.4))
        wb.create_fixture(c_, shapes.Circle(0.2), density=10.0)
    return wb.freeze(device=device, **capacity)


def web(device="cuda", **capacity):
    """Testbed/Tests/Web.h — 4 boxes suspended by 8 soft distance joints
    (freq 2 Hz) anchored to the corners and to each other."""
    wb = WorldBuilder(gravity=(0.0, -10.0))
    ground = wb.create_body()
    wb.create_fixture(ground, shapes.Edge((-40.0, 0.0), (40.0, 0.0)))
    box = shapes.Polygon.box(0.5, 0.5)
    pos = [(-5.0, 5.0), (5.0, 5.0), (5.0, 15.0), (-5.0, 15.0)]
    bodies = []
    for p in pos:
        b = wb.create_body(body_type=settings.DYNAMIC_BODY, position=p)
        wb.create_fixture(b, box, density=5.0)
        bodies.append(b)
    # corner anchors: (ground local, body local) per Web.h:60-120
    corner = [((-10.0, 0.0), (-0.5, -0.5)), ((10.0, 0.0), (0.5, -0.5)),
              ((10.0, 20.0), (0.5, 0.5)), ((-10.0, 20.0), (-0.5, 0.5))]
    for i, (ga, la) in enumerate(corner):
        wa = (pos[i][0] + la[0], pos[i][1] + la[1])
        wb.create_distance_joint(ground, bodies[i], ga, wa, frequency=2.0)
    inner = [(0, 1, (0.5, 0.0), (-0.5, 0.0)), (1, 2, (0.0, 0.5), (0.0, -0.5)),
             (2, 3, (-0.5, 0.0), (0.5, 0.0)), (3, 0, (0.0, -0.5), (0.0, 0.5))]
    for a, b, la, lb in inner:
        wa = (pos[a][0] + la[0], pos[a][1] + la[1])
        wbp = (pos[b][0] + lb[0], pos[b][1] + lb[1])
        wb.create_distance_joint(bodies[a], bodies[b], wa, wbp, frequency=2.0)
    return wb.freeze(device=device, **capacity)


def bridge(n=30, device="cuda", **capacity):
    """Testbed/Tests/Bridge.h — n revolute-chained planks + 2 triangle
    polygons and 3 circles dropped on top."""
    wb = WorldBuilder(gravity=(0.0, -10.0))
    ground = wb.create_body()
    wb.create_fixture(ground, shapes.Edge((-40.0, 0.0), (40.0, 0.0)))
    plank = shapes.Polygon.box(0.5, 0.125)
    prev = ground
    for i in range(n):
        b = wb.create_body(body_type=settings.DYNAMIC_BODY,
                           position=(-14.5 + 1.0 * i, 5.0))
        wb.create_fixture(b, plank, density=20.0, friction=0.2)
        wb.create_revolute_joint(prev, b, (-15.0 + 1.0 * i, 5.0))
        prev = b
    wb.create_revolute_joint(prev, ground, (-15.0 + 1.0 * n, 5.0))
    tri = shapes.Polygon.from_vertices([(-0.5, 0.0), (0.5, 0.0), (0.0, 1.5)])
    for i in range(2):
        b = wb.create_body(body_type=settings.DYNAMIC_BODY,
                           position=(-8.0 + 8.0 * i, 12.0))
        wb.create_fixture(b, tri, density=1.0)
    for i in range(3):
        b = wb.create_body(body_type=settings.DYNAMIC_BODY,
                           position=(-6.0 + 6.0 * i, 10.0))
        wb.create_fixture(b, shapes.Circle(0.5), density=1.0)
    return wb.freeze(device=device, **capacity)


def sphere_stack(n=10, device="cuda", **capacity):
    """Testbed/Tests/SphereStack.h — n unit circles dropped at -50 m/s."""
    wb = WorldBuilder(gravity=(0.0, -10.0))
    ground = wb.create_body()
    wb.create_fixture(ground, shapes.Edge((-40.0, 0.0), (40.0, 0.0)))
    for i in range(n):
        b = wb.create_body(body_type=settings.DYNAMIC_BODY,
                           position=(0.0, 4.0 + 3.0 * i),
                           linear_velocity=(0.0, -50.0))
        wb.create_fixture(b, shapes.Circle(1.0), density=1.0)
    return wb.freeze(device=device, **capacity)


def heavy_on_light(device="cuda", **capacity):
    """Testbed/Tests/HeavyOnLight.h — a 10x-radius (100x-mass) circle
    resting on a small one: mass-ratio stress for the solver."""
    wb = WorldBuilder(gravity=(0.0, -10.0))
    ground = wb.create_body()
    wb.create_fixture(ground, shapes.Edge((-40.0, 0.0), (40.0, 0.0)))
    light = wb.create_body(body_type=settings.DYNAMIC_BODY, position=(0.0, 0.5))
    wb.create_fixture(light, shapes.Circle(0.5), density=10.0)
    heavy = wb.create_body(body_type=settings.DYNAMIC_BODY, position=(0.0, 6.0))
    wb.create_fixture(heavy, shapes.Circle(5.0), density=10.0)
    return wb.freeze(device=device, **capacity)


def slider_crank(device="cuda", **capacity):
    """Testbed/Tests/BasicSliderCrank.h — crank / connecting rod / piston
    (revolute + revolute + revolute + prismatic)."""
    wb = WorldBuilder(gravity=(0.0, -10.0))
    ground = wb.create_body(position=(0.0, 17.0))
    crank = wb.create_body(body_type=settings.DYNAMIC_BODY,
                           position=(-8.0, 20.0))
    wb.create_fixture(crank, shapes.Polygon.box(4.0, 1.0), density=2.0)
    wb.create_revolute_joint(ground, crank, (-12.0, 20.0))
    rod = wb.create_body(body_type=settings.DYNAMIC_BODY, position=(4.0, 20.0))
    wb.create_fixture(rod, shapes.Polygon.box(8.0, 1.0), density=2.0)
    wb.create_revolute_joint(crank, rod, (-4.0, 20.0))
    piston = wb.create_body(body_type=settings.DYNAMIC_BODY,
                            position=(12.0, 20.0), fixed_rotation=True)
    wb.create_fixture(piston, shapes.Polygon.box(3.0, 3.0), density=2.0)
    wb.create_revolute_joint(rod, piston, (12.0, 20.0))
    wb.create_prismatic_joint(ground, piston, (12.0, 17.0), (1.0, 0.0))
    return wb.freeze(device=device, **capacity)


def add_pair(n=400, seed=7, device="cuda", **capacity):
    """Testbed/Tests/AddPair.h — zero gravity; a 1.5-half-extent bullet box
    at 150 m/s plows through n tiny circles (broad-phase AddPair stress)."""
    rng = random.Random(seed)
    wb = WorldBuilder(gravity=(0.0, 0.0))
    circle = shapes.Circle(0.1)
    for _ in range(n):
        b = wb.create_body(body_type=settings.DYNAMIC_BODY,
                           position=(rng.uniform(-6.0, 0.0),
                                     rng.uniform(4.0, 6.0)))
        wb.create_fixture(b, circle, density=0.01)
    bullet = wb.create_body(body_type=settings.DYNAMIC_BODY,
                            position=(-40.0, 5.0), bullet=True,
                            linear_velocity=(150.0, 0.0))
    wb.create_fixture(bullet, shapes.Polygon.box(1.5, 1.5), density=1.0)
    return wb.freeze(device=device, **capacity)


def confined(columns=8, rows=6, device="cuda", **capacity):
    """Testbed/Tests/Confined.h — circles sealed in an edge box, zero
    gravity (containment + resting-contact stress)."""
    wb = WorldBuilder(gravity=(0.0, 0.0))
    ground = wb.create_body()
    wb.create_fixture(ground, shapes.Edge((-10.0, 0.0), (10.0, 0.0)))
    wb.create_fixture(ground, shapes.Edge((-10.0, 0.0), (-10.0, 20.0)))
    wb.create_fixture(ground, shapes.Edge((10.0, 0.0), (10.0, 20.0)))
    wb.create_fixture(ground, shapes.Edge((-10.0, 20.0), (10.0, 20.0)))
    r = 0.5
    for j in range(columns):
        for i in range(rows):
            b = wb.create_body(
                body_type=settings.DYNAMIC_BODY,
                position=(-10.0 + (2.1 * j + 1.0 + 0.01 * i) * r,
                          (2.0 * i + 1.0) * r))
            wb.create_fixture(b, shapes.Circle(r), density=1.0, friction=0.1)
    return wb.freeze(device=device, **capacity)


def mobile(depth=4, device="cuda", **capacity):
    """Testbed/Tests/Mobile.h — balanced binary tree of slats hung on
    revolute joints from a ground point."""
    wb = WorldBuilder(gravity=(0.0, -10.0))
    ground = wb.create_body(position=(0.0, 20.0))
    a = 0.5
    positions = {ground: (0.0, 20.0)}

    def add_node(parent, local_anchor, d, offset):
        px, py = positions[parent]
        p = (px + local_anchor[0], py + local_anchor[1] - a)
        body = wb.create_body(body_type=settings.DYNAMIC_BODY, position=p)
        wb.create_fixture(body, shapes.Polygon.box(0.25 * a, a), density=20.0)
        positions[body] = p
        if d == depth:
            return body
        # reference creates BOTH children, then both joints (Mobile.h:55-67)
        c1 = add_node(body, (offset, -a), d + 1, 0.5 * offset)
        c2 = add_node(body, (-offset, -a), d + 1, 0.5 * offset)
        wb.create_revolute_joint(body, c1, (p[0] + offset, p[1] - a))
        wb.create_revolute_joint(body, c2, (p[0] - offset, p[1] - a))
        return body

    root = add_node(ground, (0.0, 0.0), 0, 3.0)
    wb.create_revolute_joint(ground, root, (0.0, 20.0))
    return wb.freeze(device=device, **capacity)


def body_types(device="cuda", **capacity):
    """Testbed/Tests/BodyTypes.h — attachment + motorized platform
    (revolute motor + prismatic motor/limit) + payload box. The reference
    flips the platform's body type at runtime (mutate.set_body_type)."""
    wb = WorldBuilder(gravity=(0.0, -10.0))
    ground = wb.create_body()
    wb.create_fixture(ground, shapes.Edge((-20.0, 0.0), (20.0, 0.0)))
    attachment = wb.create_body(body_type=settings.DYNAMIC_BODY,
                                position=(0.0, 3.0))
    wb.create_fixture(attachment, shapes.Polygon.box(0.5, 2.0), density=2.0)
    platform = wb.create_body(body_type=settings.DYNAMIC_BODY,
                              position=(-4.0, 5.0))
    wb.create_fixture(platform,
                      shapes.Polygon.box(0.5, 4.0, (4.0, 0.0), 0.5 * math.pi),
                      density=2.0, friction=0.6)
    wb.create_revolute_joint(attachment, platform, (0.0, 5.0),
                             enable_motor=True, max_motor_torque=50.0)
    wb.create_prismatic_joint(ground, platform, (0.0, 5.0), (1.0, 0.0),
                              enable_motor=True, max_motor_force=1000.0,
                              enable_limit=True, lower_translation=-10.0,
                              upper_translation=10.0)
    payload = wb.create_body(body_type=settings.DYNAMIC_BODY,
                             position=(0.0, 8.0))
    wb.create_fixture(payload, shapes.Polygon.box(0.75, 0.75), density=2.0,
                      friction=0.6)
    return wb.freeze(device=device, **capacity)


def varying_friction(device="cuda", **capacity):
    """Testbed/Tests/VaryingFriction.h — 5 boxes with friction 0.75..0 on
    a zig-zag of ramps."""
    wb = WorldBuilder(gravity=(0.0, -10.0))
    box = shapes.Polygon.box
    g = wb.create_body()
    wb.create_fixture(g, shapes.Edge((-40.0, 0.0), (40.0, 0.0)))
    for pos, ang, hx, hy in [((-4.0, 22.0), -0.25, 13.0, 0.25),
                             ((10.5, 19.0), 0.0, 0.25, 1.0),
                             ((4.0, 14.0), 0.25, 13.0, 0.25),
                             ((-10.5, 11.0), 0.0, 0.25, 1.0),
                             ((-4.0, 6.0), -0.25, 13.0, 0.25)]:
        r = wb.create_body(position=pos, angle=ang)
        wb.create_fixture(r, box(hx, hy))
    for i, fr in enumerate([0.75, 0.5, 0.35, 0.1, 0.0]):
        b = wb.create_body(body_type=settings.DYNAMIC_BODY,
                           position=(-15.0 + 4.0 * i, 28.0))
        wb.create_fixture(b, box(0.5, 0.5), density=25.0, friction=fr)
    return wb.freeze(device=device, **capacity)


def varying_restitution(device="cuda", **capacity):
    """Testbed/Tests/VaryingRestitution.h — 7 circles with restitution
    0..1 bouncing on the ground."""
    wb = WorldBuilder(gravity=(0.0, -10.0))
    g = wb.create_body()
    wb.create_fixture(g, shapes.Edge((-40.0, 0.0), (40.0, 0.0)))
    for i, rest in enumerate([0.0, 0.1, 0.3, 0.5, 0.75, 0.9, 1.0]):
        b = wb.create_body(body_type=settings.DYNAMIC_BODY,
                           position=(-10.0 + 3.0 * i, 20.0))
        wb.create_fixture(b, shapes.Circle(1.0), density=1.0,
                          restitution=rest)
    return wb.freeze(device=device, **capacity)


def compound_shapes(n=10, seed=3, device="cuda", **capacity):
    """Testbed/Tests/CompoundShapes.h — columns of 2-fixture bodies:
    circle pairs, box pairs, and rotated-triangle pairs."""
    rng = random.Random(seed)
    wb = WorldBuilder(gravity=(0.0, -10.0))
    g = wb.create_body()
    wb.create_fixture(g, shapes.Edge((50.0, 0.0), (-50.0, 0.0)))
    c1 = shapes.Circle(0.5, (-0.5, 0.5))
    c2 = shapes.Circle(0.5, (0.5, 0.5))
    for i in range(n):
        b = wb.create_body(body_type=settings.DYNAMIC_BODY,
                           position=(rng.uniform(-0.1, 0.1) + 5.0,
                                     1.05 + 2.5 * i),
                           angle=rng.uniform(-math.pi, math.pi))
        wb.create_fixture(b, c1, density=2.0)
        wb.create_fixture(b, c2, density=0.0)
    p1 = shapes.Polygon.box(0.25, 0.5)
    p2 = shapes.Polygon.box(0.25, 0.5, (0.0, -0.5), 0.5 * math.pi)
    for i in range(n):
        b = wb.create_body(body_type=settings.DYNAMIC_BODY,
                           position=(rng.uniform(-0.1, 0.1) - 5.0,
                                     1.05 + 2.5 * i),
                           angle=rng.uniform(-math.pi, math.pi))
        wb.create_fixture(b, p1, density=2.0)
        wb.create_fixture(b, p2, density=2.0)

    def _tri(sign):
        q = 0.3524 * math.pi * sign
        c, s = math.cos(q), math.sin(q)
        px, py = c * sign, s * sign  # xf.p = ±q.GetXAxis()
        pts = [(-1.0, 0.0), (1.0, 0.0), (0.0, 0.5)]
        return shapes.Polygon.from_vertices(
            [(c * x - s * y + px, s * x + c * y + py) for x, y in pts])

    t1, t2 = _tri(1.0), _tri(-1.0)
    for i in range(n):
        b = wb.create_body(body_type=settings.DYNAMIC_BODY,
                           position=(rng.uniform(-0.1, 0.1),
                                     2.05 + 2.5 * i))
        wb.create_fixture(b, t1, density=2.0)
        wb.create_fixture(b, t2, density=2.0)
    return wb.freeze(device=device, **capacity)


def sensor_zone(n=7, device="cuda", **capacity):
    """Testbed/Tests/SensorTest.h — a static sensor circle (r=5 at (0,10))
    with n circles falling through it; exercises sensor begin/end events."""
    wb = WorldBuilder(gravity=(0.0, -10.0))
    ground = wb.create_body()
    wb.create_fixture(ground, shapes.Edge((-40.0, 0.0), (40.0, 0.0)))
    wb.create_fixture(ground, shapes.Circle(5.0, (0.0, 10.0)),
                      is_sensor=True)
    for i in range(n):
        b = wb.create_body(body_type=settings.DYNAMIC_BODY,
                           position=(-10.0 + 3.0 * i, 20.0))
        wb.create_fixture(b, shapes.Circle(1.0), density=1.0)
    return wb.freeze(device=device, **capacity)


def collision_filtering(device="cuda", **capacity):
    """Testbed/Tests/CollisionFiltering.h — group/category/mask demo:
    small shapes (group +1) always collide, large ones (group -1) never,
    boxes don't collide with triangles via mask bits."""
    k_tri_cat, k_box_cat, k_circ_cat = 0x0002, 0x0004, 0x0008
    k_tri_mask = 0xFFFF
    k_box_mask = 0xFFFF ^ k_tri_cat
    k_circ_mask = 0xFFFF
    wb = WorldBuilder(gravity=(0.0, -10.0))
    g = wb.create_body()
    wb.create_fixture(g, shapes.Edge((-40.0, 0.0), (40.0, 0.0)),
                      friction=0.3)
    tri = [(-1.0, 0.0), (1.0, 0.0), (0.0, 2.0)]
    small_tri = wb.create_body(body_type=settings.DYNAMIC_BODY,
                               position=(-5.0, 2.0))
    wb.create_fixture(small_tri, shapes.Polygon.from_vertices(tri),
                      density=1.0, filter_group=1,
                      filter_category=k_tri_cat, filter_mask=k_tri_mask)
    big_tri = wb.create_body(body_type=settings.DYNAMIC_BODY,
                             position=(-5.0, 6.0), fixed_rotation=True)
    wb.create_fixture(big_tri,
                      shapes.Polygon.from_vertices(
                          [(2 * x, 2 * y) for x, y in tri]),
                      density=1.0, filter_group=-1,
                      filter_category=k_tri_cat, filter_mask=k_tri_mask)
    dangler = wb.create_body(body_type=settings.DYNAMIC_BODY,
                             position=(-5.0, 10.0))
    wb.create_fixture(dangler, shapes.Polygon.box(0.5, 1.0), density=1.0)
    wb.create_prismatic_joint(big_tri, dangler, (-5.0, 10.0), (0.0, 1.0),
                              enable_limit=True, lower_translation=-1.0,
                              upper_translation=1.0)
    small_box = wb.create_body(body_type=settings.DYNAMIC_BODY,
                               position=(0.0, 2.0))
    wb.create_fixture(small_box, shapes.Polygon.box(1.0, 0.5),
                      density=1.0, restitution=0.1, filter_group=1,
                      filter_category=k_box_cat, filter_mask=k_box_mask)
    big_box = wb.create_body(body_type=settings.DYNAMIC_BODY,
                             position=(0.0, 6.0))
    wb.create_fixture(big_box, shapes.Polygon.box(2.0, 1.0), density=1.0,
                      restitution=0.1, filter_group=-1,
                      filter_category=k_box_cat, filter_mask=k_box_mask)
    small_circ = wb.create_body(body_type=settings.DYNAMIC_BODY,
                                position=(5.0, 2.0))
    wb.create_fixture(small_circ, shapes.Circle(1.0), density=1.0,
                      filter_group=1, filter_category=k_circ_cat,
                      filter_mask=k_circ_mask)
    big_circ = wb.create_body(body_type=settings.DYNAMIC_BODY,
                              position=(5.0, 6.0))
    wb.create_fixture(big_circ, shapes.Circle(2.0), density=1.0,
                      filter_group=-1, filter_category=k_circ_cat,
                      filter_mask=k_circ_mask)
    return wb.freeze(device=device, **capacity)


def pinball(device="cuda", **capacity):
    """Testbed/Tests/Pinball.h — chain-loop table, two motorized limited
    flippers, and a bullet ball (CCD + chain + revolute limits)."""
    wb = WorldBuilder(gravity=(0.0, -10.0))
    ground = wb.create_body()
    wb.create_fixture(ground, shapes.Chain(
        [(0.0, -2.0), (8.0, 6.0), (8.0, 20.0), (-8.0, 20.0), (-8.0, 6.0)],
        loop=True))
    box = shapes.Polygon.box(1.75, 0.1)
    left = wb.create_body(body_type=settings.DYNAMIC_BODY,
                          position=(-2.0, 0.0))
    wb.create_fixture(left, box, density=1.0)
    right = wb.create_body(body_type=settings.DYNAMIC_BODY,
                           position=(2.0, 0.0))
    wb.create_fixture(right, box, density=1.0)
    wb.create_revolute_joint(ground, left, (-2.0, 0.0),
                             enable_motor=True, max_motor_torque=1000.0,
                             motor_speed=-10.0, enable_limit=True,
                             lower_angle=-30.0 * math.pi / 180.0,
                             upper_angle=5.0 * math.pi / 180.0)
    wb.create_revolute_joint(ground, right, (2.0, 0.0),
                             enable_motor=True, max_motor_torque=1000.0,
                             motor_speed=10.0, enable_limit=True,
                             lower_angle=-5.0 * math.pi / 180.0,
                             upper_angle=30.0 * math.pi / 180.0)
    ball = wb.create_body(body_type=settings.DYNAMIC_BODY,
                          position=(1.0, 15.0), bullet=True)
    wb.create_fixture(ball, shapes.Circle(0.2), density=1.0)
    return wb.freeze(device=device, **capacity)


def theo_jansen(device="cuda", **capacity):
    """Testbed/Tests/TheoJansen.h — Theo Jansen walker: chassis + motorized
    wheel + 6 linkage legs (24 soft distance joints, 6 revolutes, group -1
    self-filtering) walking over a floor of 40 small circles."""
    off = (0.0, 8.0)
    pivot = (0.0, 0.8)
    wb = WorldBuilder(gravity=(0.0, -10.0))
    ground = wb.create_body()
    wb.create_fixture(ground, shapes.Edge((-50.0, 0.0), (50.0, 0.0)))
    wb.create_fixture(ground, shapes.Edge((-50.0, 0.0), (-50.0, 10.0)))
    wb.create_fixture(ground, shapes.Edge((50.0, 0.0), (50.0, 10.0)))
    for i in range(40):
        b = wb.create_body(body_type=settings.DYNAMIC_BODY,
                           position=(-40.0 + 2.0 * i, 0.5))
        wb.create_fixture(b, shapes.Circle(0.25), density=1.0)
    chassis = wb.create_body(body_type=settings.DYNAMIC_BODY,
                             position=(pivot[0] + off[0], pivot[1] + off[1]))
    wb.create_fixture(chassis, shapes.Polygon.box(2.5, 1.0), density=1.0,
                      filter_group=-1)
    wheel = wb.create_body(body_type=settings.DYNAMIC_BODY,
                           position=(pivot[0] + off[0], pivot[1] + off[1]))
    wb.create_fixture(wheel, shapes.Circle(1.6), density=1.0,
                      filter_group=-1)
    wb.create_revolute_joint(wheel, chassis,
                             (pivot[0] + off[0], pivot[1] + off[1]),
                             enable_motor=True, motor_speed=2.0,
                             max_motor_torque=400.0)
    wheel_anchor = (pivot[0], pivot[1] - 0.8)

    def leg(s, wheel_angle):
        p1 = (5.4 * s, -6.1)
        p2 = (7.2 * s, -1.2)
        p3 = (4.3 * s, -1.9)
        p4 = (3.1 * s, 0.8)
        p5 = (6.0 * s, 1.5)
        p6 = (2.5 * s, 3.7)
        if s > 0:
            tri1 = [p1, p2, p3]
            tri2 = [(0.0, 0.0), (p5[0] - p4[0], p5[1] - p4[1]),
                    (p6[0] - p4[0], p6[1] - p4[1])]
        else:
            tri1 = [p1, p3, p2]
            tri2 = [(0.0, 0.0), (p6[0] - p4[0], p6[1] - p4[1]),
                    (p5[0] - p4[0], p5[1] - p4[1])]
        b1 = wb.create_body(body_type=settings.DYNAMIC_BODY, position=off,
                            angular_damping=10.0)
        wb.create_fixture(b1, shapes.Polygon.from_vertices(tri1),
                          density=1.0, filter_group=-1)
        b2 = wb.create_body(body_type=settings.DYNAMIC_BODY,
                            position=(p4[0] + off[0], p4[1] + off[1]),
                            angular_damping=10.0)
        wb.create_fixture(b2, shapes.Polygon.from_vertices(tri2),
                          density=1.0, filter_group=-1)
        w = lambda p: (p[0] + off[0], p[1] + off[1])
        wb.create_distance_joint(b1, b2, w(p2), w(p5), frequency=10.0,
                                 damping_ratio=0.5)
        wb.create_distance_joint(b1, b2, w(p3), w(p4), frequency=10.0,
                                 damping_ratio=0.5)
        # wheel-attached anchors: the reference rotates the wheel between
        # leg batches (SetTransform, TheoJansen.h:204-210) so each pair
        # grabs a different wheel-local point; replicate via explicit
        # local anchors on the rotated wheel.
        wa_world = w(wheel_anchor)
        c, sn = math.cos(wheel_angle), math.sin(wheel_angle)
        wheel_pos = (pivot[0] + off[0], pivot[1] + off[1])
        dxw = wa_world[0] - wheel_pos[0]
        dyw = wa_world[1] - wheel_pos[1]
        wheel_local = (c * dxw + sn * dyw, -sn * dxw + c * dyw)
        j1 = wb.create_distance_joint(b1, wheel, w(p3), wa_world,
                                      frequency=10.0, damping_ratio=0.5)
        wb._joints["distance"][j1]["local_anchor_b"] = wheel_local
        j2 = wb.create_distance_joint(b2, wheel, w(p6), wa_world,
                                      frequency=10.0, damping_ratio=0.5)
        wb._joints["distance"][j2]["local_anchor_b"] = wheel_local
        wb.create_revolute_joint(b2, chassis, w(p4))

    for ang in (0.0, 120.0 * math.pi / 180.0, -120.0 * math.pi / 180.0):
        leg(-1.0, ang)
        leg(1.0, ang)
    return wb.freeze(device=device, **capacity)


def heavy_on_light_two(with_heavy=True, device="cuda", **capacity):
    """Testbed/Tests/HeavyOnLightTwo.h:27-71 — two light r=0.5 circles
    stacked; a 100x-mass r=5 circle optionally toggled on top (the
    reference adds it at runtime via the H key)."""
    wb = WorldBuilder(gravity=(0.0, -10.0))
    ground = wb.create_body()
    wb.create_fixture(ground, shapes.Edge((-40.0, 0.0), (40.0, 0.0)))
    light = shapes.Circle(0.5)
    b = wb.create_body(body_type=settings.DYNAMIC_BODY, position=(0.0, 2.5))
    wb.create_fixture(b, light, density=10.0)
    b = wb.create_body(body_type=settings.DYNAMIC_BODY, position=(0.0, 3.5))
    wb.create_fixture(b, light, density=10.0)
    if with_heavy:
        h = wb.create_body(body_type=settings.DYNAMIC_BODY,
                           position=(0.0, 9.0))
        wb.create_fixture(h, shapes.Circle(5.0), density=10.0)
    return wb.freeze(device=device, **capacity)


def mobile_balanced(depth=4, device="cuda", **capacity):
    """Testbed/Tests/MobileBalanced.h — the mobile with an added crossbar
    fixture on every non-leaf node (MobileBalanced.h:75-76), which balances
    the mass distribution the plain Mobile lacks."""
    wb = WorldBuilder(gravity=(0.0, -10.0))
    ground = wb.create_body(position=(0.0, 20.0))
    a = 0.5
    positions = {ground: (0.0, 20.0)}

    def add_node(parent, local_anchor, d, offset):
        p = positions[parent]
        p = (p[0] + local_anchor[0], p[1] + local_anchor[1] - a)
        body = wb.create_body(body_type=settings.DYNAMIC_BODY, position=p)
        wb.create_fixture(body, shapes.Polygon.box(0.25 * a, a), density=20.0)
        positions[body] = p
        if d == depth:
            return body
        # crossbar (MobileBalanced.h:75-76)
        wb.create_fixture(body,
                          shapes.Polygon.box(offset, 0.25 * a, (0.0, -a), 0.0),
                          density=20.0)
        c1 = add_node(body, (offset, -a), d + 1, 0.5 * offset)
        c2 = add_node(body, (-offset, -a), d + 1, 0.5 * offset)
        wb.create_revolute_joint(body, c1, (p[0] + offset, p[1] - a))
        wb.create_revolute_joint(body, c2, (p[0] - offset, p[1] - a))
        return body

    root = add_node(ground, (0.0, 0.0), 0, 3.0)
    wb.create_revolute_joint(ground, root, (0.0, 20.0 - a + a))
    return wb.freeze(device=device, **capacity)


# deterministic spawn table standing in for the testbed's rand()-driven
# keypress spawner (EdgeShapes.h:131-138 RandomFloat(-10,10))
_SPAWN_XS = (-8.3, 4.1, -1.7, 7.9, -5.2, 2.6, -9.1, 0.4, 6.3, -3.8,
             8.7, -6.9, 1.2, -0.6, 5.5, -7.4, 3.3, 9.6, -2.1, -4.4)


def edge_shapes(n_bodies=12, device="cuda", **capacity):
    """Testbed/Tests/EdgeShapes.h:55-120 — cosine-wave terrain of 80 edge
    fixtures with the five canonical shapes (3 triangles/octagon/box/circle)
    dropped on it. Spawns use a fixed table standing in for the keypress
    RNG."""
    wb = WorldBuilder(gravity=(0.0, -10.0))
    ground = wb.create_body()
    x1 = -20.0
    y1 = 2.0 * math.cos(x1 / 10.0 * math.pi)
    for _ in range(80):
        x2 = x1 + 0.5
        y2 = 2.0 * math.cos(x2 / 10.0 * math.pi)
        wb.create_fixture(ground, shapes.Edge((x1, y1), (x2, y2)))
        x1, y1 = x2, y2

    w = 1.0
    b = w / (2.0 + math.sqrt(2.0))
    s = math.sqrt(2.0) * b
    octagon = [(0.5 * s, 0.0), (0.5 * w, b), (0.5 * w, b + s), (0.5 * s, w),
               (-0.5 * s, w), (-0.5 * w, b + s), (-0.5 * w, b), (-0.5 * s, 0.0)]
    zoo = [shapes.Polygon.from_vertices([(-0.5, 0.0), (0.5, 0.0), (0.0, 1.5)]),
           shapes.Polygon.from_vertices([(-0.1, 0.0), (0.1, 0.0), (0.0, 1.5)]),
           shapes.Polygon.from_vertices(octagon),
           shapes.Polygon.box(0.5, 0.5),
           shapes.Circle(0.5)]
    for i in range(n_bodies):
        is_circle = i % len(zoo) == 4
        body = wb.create_body(body_type=settings.DYNAMIC_BODY,
                              position=(_SPAWN_XS[i % len(_SPAWN_XS)], 10.0),
                              angle=(i * 0.7) % (2.0 * math.pi) - math.pi,
                              # EdgeShapes.h:142-144
                              angular_damping=0.02 if is_circle else 0.0)
        wb.create_fixture(body, zoo[i % len(zoo)], density=20.0,
                          friction=0.3)                # EdgeShapes.h:148-162
    return wb.freeze(device=device, **capacity)


def poly_shapes(n_bodies=10, device="cuda", **capacity):
    """Testbed/Tests/PolyShapes.h:112-210 — the same five-shape zoo dropped
    onto a flat edge ground (the reference adds an AABB+TestOverlap query
    overlay, covered by tests/test_queries.py)."""
    wb = WorldBuilder(gravity=(0.0, -10.0))
    ground = wb.create_body()
    wb.create_fixture(ground, shapes.Edge((-40.0, 0.0), (40.0, 0.0)))
    w = 1.0
    b = w / (2.0 + math.sqrt(2.0))
    s = math.sqrt(2.0) * b
    octagon = [(0.5 * s, 0.0), (0.5 * w, b), (0.5 * w, b + s), (0.5 * s, w),
               (-0.5 * s, w), (-0.5 * w, b + s), (-0.5 * w, b), (-0.5 * s, 0.0)]
    zoo = [shapes.Polygon.from_vertices([(-0.5, 0.0), (0.5, 0.0), (0.0, 1.5)]),
           shapes.Polygon.from_vertices([(-0.1, 0.0), (0.1, 0.0), (0.0, 1.5)]),
           shapes.Polygon.from_vertices(octagon),
           shapes.Polygon.box(0.5, 0.5),
           shapes.Circle(0.5)]
    for i in range(n_bodies):
        body = wb.create_body(body_type=settings.DYNAMIC_BODY,
                              position=(_SPAWN_XS[(i * 3 + 1) % len(_SPAWN_XS)] * 0.2,
                                        1.0 + 1.2 * i),
                              angle=(i * 1.1) % (2.0 * math.pi) - math.pi)
        wb.create_fixture(body, zoo[i % len(zoo)], density=1.0, friction=0.3)
    return wb.freeze(device=device, **capacity)


def character_collision(device="cuda", **capacity):
    """Testbed/Tests/CharacterCollision.h:28-226 — edge-chain traversal
    fixtures: collinear edges, rotated chain, square tiles, edge-loop
    square, terrain loop, plus the five characters (two fixed-rotation
    squares, hexagon, fixed-rotation circle, free r=0.25 circle)."""
    wb = WorldBuilder(gravity=(0.0, -10.0))
    g1 = wb.create_body()
    wb.create_fixture(g1, shapes.Edge((-20.0, 0.0), (20.0, 0.0)))

    g2 = wb.create_body()
    for xa in (-8.0, -6.0, -4.0):
        wb.create_fixture(g2, shapes.Edge((xa, 1.0), (xa + 2.0, 1.0)))

    g3 = wb.create_body(angle=0.25 * math.pi)
    wb.create_fixture(g3, shapes.Chain(
        [(5.0, 7.0), (6.0, 8.0), (7.0, 8.0), (8.0, 7.0)]))

    g4 = wb.create_body()
    for xc in (4.0, 6.0, 8.0):
        wb.create_fixture(g4, shapes.Polygon.box(1.0, 1.0, (xc, 3.0), 0.0))

    g5 = wb.create_body()
    wb.create_fixture(g5, shapes.Chain(
        [(-1.0, 3.0), (1.0, 3.0), (1.0, 5.0), (-1.0, 5.0)], loop=True))

    g6 = wb.create_body(position=(-10.0, 4.0))
    wb.create_fixture(g6, shapes.Chain(
        [(0.0, 0.0), (6.0, 0.0), (6.0, 2.0), (4.0, 1.0), (2.0, 2.0),
         (0.0, 2.0), (-2.0, 2.0), (-4.0, 3.0), (-6.0, 2.0), (-6.0, 0.0)],
        loop=True))

    sq1 = wb.create_body(body_type=settings.DYNAMIC_BODY,
                         position=(-3.0, 8.0), fixed_rotation=True,
                         allow_sleep=False)
    wb.create_fixture(sq1, shapes.Polygon.box(0.5, 0.5), density=20.0)
    sq2 = wb.create_body(body_type=settings.DYNAMIC_BODY,
                         position=(-5.0, 5.0), fixed_rotation=True,
                         allow_sleep=False)
    wb.create_fixture(sq2, shapes.Polygon.box(0.25, 0.25), density=20.0)

    hexagon = wb.create_body(body_type=settings.DYNAMIC_BODY,
                             position=(-5.0, 8.0), fixed_rotation=True,
                             allow_sleep=False)
    hex_pts = [(0.5 * math.cos(i * math.pi / 3.0), 0.5 * math.sin(i * math.pi / 3.0))
               for i in range(6)]
    wb.create_fixture(hexagon, shapes.Polygon.from_vertices(hex_pts),
                      density=20.0)

    circ = wb.create_body(body_type=settings.DYNAMIC_BODY,
                          position=(3.0, 5.0), fixed_rotation=True,
                          allow_sleep=False)
    wb.create_fixture(circ, shapes.Circle(0.5), density=20.0)

    char = wb.create_body(body_type=settings.DYNAMIC_BODY,
                          position=(-7.0, 6.0), allow_sleep=False)
    wb.create_fixture(char, shapes.Circle(0.25), density=20.0, friction=1.0)
    return wb.freeze(device=device, **capacity)


def chain_problem(device="cuda", **capacity):
    """Testbed/Tests/chainProblem.h — regression dump: a 1x6 bullet box
    dropped onto the corner of an L-shaped chain [(0,1),(0,0),(4,0)];
    the box must come to rest on the chain instead of snagging the
    internal vertex."""
    wb = WorldBuilder(gravity=(0.0, -10.0))
    g = wb.create_body()
    wb.create_fixture(g, shapes.Chain([(0.0, 1.0), (0.0, 0.0), (4.0, 0.0)]),
                      friction=0.2)
    b = wb.create_body(body_type=settings.DYNAMIC_BODY,
                       position=(0.6033980250358582, 3.028350114822388),
                       bullet=True)
    wb.create_fixture(b, shapes.Polygon.box(0.5, 3.0), density=10.0,
                      friction=0.2)
    return wb.freeze(device=device, **capacity)


def edge_test(device="cuda", **capacity):
    """Testbed/Tests/EdgeTest.h — six ghost-connected edges forming a
    valley/hill terrain; a circle and a box roll across the internal
    vertices without jerking (the ghost-vertex EPCollider oracle)."""
    wb = WorldBuilder(gravity=(0.0, -10.0))
    g = wb.create_body()
    v = [(-10.0, 0.0), (-7.0, -2.0), (-4.0, 0.0), (0.0, 0.0),
         (4.0, 0.0), (7.0, 2.0), (10.0, 0.0)]
    for i in range(6):
        wb.create_fixture(g, shapes.Edge(
            v[i], v[i + 1],
            v0=v[i - 1] if i > 0 else None,
            v3=v[i + 2] if i < 5 else None))
    c = wb.create_body(body_type=settings.DYNAMIC_BODY,
                       position=(-0.5, 0.6), allow_sleep=False)
    wb.create_fixture(c, shapes.Circle(0.5), density=1.0)
    b = wb.create_body(body_type=settings.DYNAMIC_BODY,
                       position=(1.0, 0.6), allow_sleep=False)
    wb.create_fixture(b, shapes.Polygon.box(0.5, 0.5), density=1.0)
    return wb.freeze(device=device, **capacity)


def collision_processing(seed=7, device="cuda", **capacity):
    """Testbed/Tests/CollisionProcessing.h — two triangles, two boxes and
    two circles scattered over the ground; the reference destroys the
    lighter body of each touching pair in Step (driven here by the
    events + mutate.remove_body API in the test)."""
    rng = random.Random(seed)
    wb = WorldBuilder(gravity=(0.0, -10.0))
    g = wb.create_body()
    wb.create_fixture(g, shapes.Edge((-50.0, 0.0), (50.0, 0.0)))

    def pos():
        return (rng.uniform(-5.0, 5.0), rng.uniform(2.0, 35.0))

    tri = [(-1.0, 0.0), (1.0, 0.0), (0.0, 2.0)]
    for scale in (1.0, 2.0):
        b = wb.create_body(body_type=settings.DYNAMIC_BODY, position=pos())
        wb.create_fixture(b, shapes.Polygon.from_vertices(
            [(scale * x, scale * y) for x, y in tri]), density=1.0)
    for hx, hy in ((1.0, 0.5), (2.0, 1.0)):
        b = wb.create_body(body_type=settings.DYNAMIC_BODY, position=pos())
        wb.create_fixture(b, shapes.Polygon.box(hx, hy), density=1.0)
    for r in (1.0, 2.0):
        b = wb.create_body(body_type=settings.DYNAMIC_BODY, position=pos())
        wb.create_fixture(b, shapes.Circle(r), density=1.0)
    return wb.freeze(device=device, **capacity)


def sleep_collide_perf(pyramids=4, pyramid_size=10, tumblers=2,
                       boxes_per_tumbler=50, device="cuda", **capacity):
    """Testbed/Tests/SleepCollidePerf.h — the reference's sleep-scaling
    perf scene: `pyramids` box pyramids that settle and sleep next to
    spinning no-sleep tumblers full of boxes; throughput hinges on the
    solver skipping the sleeping pyramids."""
    rng = random.Random(11)
    wb = WorldBuilder(gravity=(0.0, -10.0))
    g = wb.create_body()
    wb.create_fixture(g, shapes.Edge((-20.0 * pyramids, 0.0),
                                     (20.0 * pyramids, 0.0)))
    box = shapes.Polygon.box
    x_spacing = 1.125 * pyramid_size
    x_init = -x_spacing * pyramids * 0.5 - 7.0
    sq = box(0.5, 0.5)
    for p in range(pyramids):
        x = (x_init + p * x_spacing, 0.75)
        for i in range(pyramid_size):
            y = x
            for j in range(i, pyramid_size):
                b = wb.create_body(body_type=settings.DYNAMIC_BODY,
                                   position=y)
                wb.create_fixture(b, sq, density=5.0)
                y = (y[0] + 1.125, y[1])
            x = (x[0] + 0.5625, x[1] + 1.25)
    x = -30.0 * tumblers * 0.5 + 10.0
    for t in range(tumblers):
        body = wb.create_body(body_type=settings.DYNAMIC_BODY,
                              position=(x, 50.0), allow_sleep=False)
        wb.create_fixture(body, box(0.5, 10.0, (10.0, 0.0), 0.0), density=5.0)
        wb.create_fixture(body, box(0.5, 10.0, (-10.0, 0.0), 0.0), density=5.0)
        wb.create_fixture(body, box(10.0, 0.5, (0.0, 10.0), 0.0), density=5.0)
        wb.create_fixture(body, box(10.0, 0.5, (0.0, -10.0), 0.0), density=5.0)
        wb.create_revolute_joint(g, body, (x, 50.0), enable_motor=True,
                                 motor_speed=0.05 * 3.141592653589793,
                                 max_motor_torque=1e8)
        for _ in range(boxes_per_tumbler):
            b = wb.create_body(body_type=settings.DYNAMIC_BODY,
                               position=(x + rng.uniform(-5, 5),
                                         50.0 + rng.uniform(-5, 5)))
            wb.create_fixture(b, box(0.125, 0.125), density=1.0)
        x += 30.0
    return wb.freeze(device=device, **capacity)


def basic_slider_crank(device="cuda", **capacity):
    """Testbed/Tests/BasicSliderCrank.h — crank / connecting-rod / piston
    chain of revolutes plus a horizontal prismatic guide on the piston
    (fixed rotation), all hanging from a ground pivot at (0, 17)."""
    wb = WorldBuilder(gravity=(0.0, -10.0))
    ground = wb.create_body(position=(0.0, 17.0))
    crank = wb.create_body(body_type=settings.DYNAMIC_BODY,
                           position=(-8.0, 20.0))
    wb.create_fixture(crank, shapes.Polygon.box(4.0, 1.0), density=2.0)
    wb.create_revolute_joint(ground, crank, (-12.0, 20.0))
    rod = wb.create_body(body_type=settings.DYNAMIC_BODY,
                         position=(4.0, 20.0))
    wb.create_fixture(rod, shapes.Polygon.box(8.0, 1.0), density=2.0)
    wb.create_revolute_joint(crank, rod, (-4.0, 20.0))
    piston = wb.create_body(body_type=settings.DYNAMIC_BODY,
                            position=(12.0, 20.0), fixed_rotation=True)
    wb.create_fixture(piston, shapes.Polygon.box(3.0, 3.0), density=2.0)
    wb.create_revolute_joint(rod, piston, (12.0, 20.0))
    wb.create_prismatic_joint(ground, piston, (12.0, 17.0), (1.0, 0.0))
    return wb.freeze(device=device, **capacity)


def sensor_drop(device="cuda", **capacity):
    """The sensor golden's scene (tests/test_callbacks.py, sensor_180.jsonl):
    a ball falls through a static box sensor onto an edge ground; the
    sensor's begin and end steps are the reference's."""
    wb = WorldBuilder(gravity=(0.0, -10.0))
    ground = wb.create_body()
    wb.create_fixture(ground, shapes.Edge((-40.0, 0.0), (40.0, 0.0)))
    sensor_body = wb.create_body(position=(0.0, 6.0))
    wb.create_fixture(sensor_body, shapes.Polygon.box(2.0, 1.0), is_sensor=True)
    ball = wb.create_body(body_type=settings.DYNAMIC_BODY, position=(0.0, 12.0))
    wb.create_fixture(ball, shapes.Circle(0.5), density=1.0)
    return wb.freeze(device=device, **capacity)


def friction_top_down(device="cuda", **capacity):
    """Golden scene: sliding box damped by a friction joint (golden2.cpp)."""
    wb = WorldBuilder(gravity=(0.0, 0.0))
    ground = wb.create_body()
    b = wb.create_body(body_type=settings.DYNAMIC_BODY, position=(2.0, 8.0),
                       linear_velocity=(8.0, 3.0), angular_velocity=5.0)
    wb.create_fixture(b, shapes.Polygon.box(0.5, 0.5), density=5.0)
    # the reference def puts both local anchors at (0, 0)
    wb.create_joint_raw("friction", body_a=ground, body_b=b,
                        local_anchor_a=(0.0, 0.0), local_anchor_b=(0.0, 0.0),
                        max_force=10.0, max_torque=10.0, collide_connected=False)
    return wb.freeze(device=device, **capacity)


def rope_swing(device="cuda", **capacity):
    """Golden scene: box dropping to a 5 m rope limit (golden2.cpp)."""
    wb = WorldBuilder(gravity=(0.0, -10.0))
    ground = wb.create_body()
    b = wb.create_body(body_type=settings.DYNAMIC_BODY, position=(2.0, 8.0))
    wb.create_fixture(b, shapes.Polygon.box(0.5, 0.5), density=5.0)
    wb.create_rope_joint(ground, b, (0.0, 10.0), (0.0, 0.0), 5.0)
    return wb.freeze(device=device, **capacity)


def motor_drive(device="cuda", **capacity):
    """Golden scene: motor joint pulling a kicked box back (golden2.cpp)."""
    wb = WorldBuilder(gravity=(0.0, -10.0))
    ground = wb.create_body()
    b = wb.create_body(body_type=settings.DYNAMIC_BODY, position=(2.0, 8.0),
                       linear_velocity=(5.0, 0.0))
    wb.create_fixture(b, shapes.Polygon.box(0.5, 0.5), density=5.0)
    wb.create_motor_joint(ground, b, max_force=1000.0, max_torque=1000.0)
    return wb.freeze(device=device, **capacity)


def wheel_car(device="cuda", **capacity):
    """Golden scene: motorized wheel and chassis on the ground
    (golden3.cpp, after Testbed Car.h)."""
    wb = WorldBuilder(gravity=(0.0, -10.0))
    ground = wb.create_body()
    wb.create_fixture(ground, shapes.Edge((-40.0, 0.0), (40.0, 0.0)))
    wheel = wb.create_body(body_type=settings.DYNAMIC_BODY, position=(0.0, 1.0))
    wb.create_fixture(wheel, shapes.Circle(0.4), density=1.0, friction=0.9)
    chassis = wb.create_body(body_type=settings.DYNAMIC_BODY, position=(0.0, 2.0))
    wb.create_fixture(chassis, shapes.Polygon.box(1.0, 0.25), density=1.0)
    wb.create_wheel_joint(chassis, wheel, (0.0, 1.0), (0.0, 1.0),
                          enable_motor=True, motor_speed=-10.0,
                          max_motor_torque=20.0, frequency=4.0,
                          damping_ratio=0.7)
    return wb.freeze(device=device, **capacity)


def gear_train(device="cuda", **capacity):
    """Golden scene (golden4.cpp, after Testbed Gears.h): two circle gears
    pinned to the ground by revolutes and coupled by a gear joint of ratio
    r2/r1, and a vertical rack on a prismatic joint coupled to the big
    gear with ratio -1/r2. Gravity drives the rack; the gears drive the
    wheels."""
    wb = WorldBuilder(gravity=(0.0, -10.0))
    ground = wb.create_body()
    wb.create_fixture(ground, shapes.Edge((-40.0, 0.0), (40.0, 0.0)))
    g1 = wb.create_body(body_type=settings.DYNAMIC_BODY,
                        position=(-3.5, 12.0), angular_velocity=2.0)
    wb.create_fixture(g1, shapes.Circle(1.0), density=5.0)
    g2 = wb.create_body(body_type=settings.DYNAMIC_BODY, position=(0.0, 12.0))
    wb.create_fixture(g2, shapes.Circle(2.0), density=5.0)
    rack = wb.create_body(body_type=settings.DYNAMIC_BODY, position=(3.0, 12.0))
    wb.create_fixture(rack, shapes.Polygon.box(0.25, 1.5), density=5.0)
    rev1 = wb.create_revolute_joint(ground, g1, (-3.5, 12.0))
    rev2 = wb.create_revolute_joint(ground, g2, (0.0, 12.0))
    prism = wb.create_prismatic_joint(ground, rack, (3.0, 12.0), (0.0, 1.0),
                                      enable_limit=True, lower_translation=-5.0,
                                      upper_translation=5.0)
    wb.create_gear_joint(("revolute", rev1), ("revolute", rev2), ratio=2.0)
    wb.create_gear_joint(("revolute", rev2), ("prismatic", prism), ratio=-0.5)
    return wb.freeze(device=device, **capacity)


def pulley_pair(device="cuda", **capacity):
    """Golden scene: a 1.5-ratio pulley between two boxes (golden3.cpp)."""
    wb = WorldBuilder(gravity=(0.0, -10.0))
    ground = wb.create_body()
    a = wb.create_body(body_type=settings.DYNAMIC_BODY, position=(-2.0, 5.0))
    wb.create_fixture(a, shapes.Polygon.box(0.5, 0.5), density=5.0)
    b = wb.create_body(body_type=settings.DYNAMIC_BODY, position=(2.0, 5.0))
    wb.create_fixture(b, shapes.Polygon.box(0.5, 1.0), density=5.0)
    wb.create_pulley_joint(a, b, (-2.0, 10.0), (2.0, 10.0),
                           (-2.0, 5.5), (2.0, 6.0), 1.5)
    return wb.freeze(device=device, **capacity)


def car(device="cuda", **capacity):
    """Testbed/Tests/Car.h — a 6-vertex chassis on two wheel-jointed wheels
    (4 Hz, 0.7 damping, rear motor on) driving over hilly edge terrain, a
    limited revolute teeter and a 20-plank bridge, with 5 stacked boxes."""
    wb = WorldBuilder(gravity=(0.0, -10.0))
    ground = wb.create_body()

    def e(a, b):
        wb.create_fixture(ground, shapes.Edge(a, b), friction=0.6)

    e((-20.0, 0.0), (20.0, 0.0))
    hs = [0.25, 1.0, 4.0, 0.0, 0.0, -1.0, -2.0, -2.0, -1.25, 0.0]
    x, y1, dx = 20.0, 0.0, 5.0
    for _ in range(2):
        for h in hs:
            e((x, y1), (x + dx, h))
            y1 = h
            x += dx
    e((x, 0.0), (x + 40.0, 0.0))
    x += 80.0
    e((x, 0.0), (x + 40.0, 0.0))
    x += 40.0
    e((x, 0.0), (x + 10.0, 5.0))
    x += 20.0
    e((x, 0.0), (x + 40.0, 0.0))
    x += 40.0
    e((x, 0.0), (x, 20.0))
    # teeter: +-8 degree revolute limit, kicked by a 100 N*m*s angular impulse
    teeter = wb.create_body(body_type=settings.DYNAMIC_BODY, position=(140.0, 1.0))
    wb.create_fixture(teeter, shapes.Polygon.box(10.0, 0.25), density=1.0)
    md = shapes.Polygon.box(10.0, 0.25).compute_mass(1.0)
    wb._bodies[teeter].angular_velocity = 100.0 / md.inertia
    wb.create_revolute_joint(ground, teeter, (140.0, 1.0), enable_limit=True,
                             lower_angle=-8.0 * math.pi / 180.0,
                             upper_angle=8.0 * math.pi / 180.0)
    prev = ground
    for i in range(20):
        b = wb.create_body(body_type=settings.DYNAMIC_BODY,
                           position=(161.0 + 2.0 * i, -0.125))
        wb.create_fixture(b, shapes.Polygon.box(1.0, 0.125), density=1.0,
                          friction=0.6)
        wb.create_revolute_joint(prev, b, (160.0 + 2.0 * i, -0.125))
        prev = b
    wb.create_revolute_joint(prev, ground, (160.0 + 2.0 * 20, -0.125))
    for i in range(5):
        b = wb.create_body(body_type=settings.DYNAMIC_BODY, position=(230.0, 0.5 + i))
        wb.create_fixture(b, shapes.Polygon.box(0.5, 0.5), density=0.5)
    chassis = wb.create_body(body_type=settings.DYNAMIC_BODY, position=(0.0, 1.0))
    wb.create_fixture(chassis, shapes.Polygon.from_vertices(
        [(-1.5, -0.5), (1.5, -0.5), (1.5, 0.0), (0.0, 0.9),
         (-1.15, 0.9), (-1.5, 0.2)]), density=1.0)
    w1 = wb.create_body(body_type=settings.DYNAMIC_BODY, position=(-1.0, 0.35))
    wb.create_fixture(w1, shapes.Circle(0.4), density=1.0, friction=0.9)
    w2 = wb.create_body(body_type=settings.DYNAMIC_BODY, position=(1.0, 0.4))
    wb.create_fixture(w2, shapes.Circle(0.4), density=1.0, friction=0.9)
    wb.create_wheel_joint(chassis, w1, (-1.0, 0.35), (0.0, 1.0),
                          enable_motor=True, motor_speed=-30.0,
                          max_motor_torque=20.0, frequency=4.0,
                          damping_ratio=0.7)
    wb.create_wheel_joint(chassis, w2, (1.0, 0.4), (0.0, 1.0),
                          enable_motor=False, max_motor_torque=10.0,
                          frequency=4.0, damping_ratio=0.7)
    return wb.freeze(device=device, **capacity)


def apply_force(device="cuda", **capacity):
    """Testbed/Tests/ApplyForce.h:27-144 — zero gravity, four restitution
    walls boxing (0, 20), a damped two-triangle 'ship', and ten boxes
    pinned by top-down friction joints (maxForce = m*g, maxTorque =
    m*r*g)."""
    wb = WorldBuilder(gravity=(0.0, 0.0))
    ground = wb.create_body(position=(0.0, 20.0))
    for v1, v2 in (((-20.0, -20.0), (-20.0, 20.0)), ((20.0, -20.0), (20.0, 20.0)),
                   ((-20.0, 20.0), (20.0, 20.0)), ((-20.0, -20.0), (20.0, -20.0))):
        wb.create_fixture(ground, shapes.Edge(v1, v2), restitution=0.4)

    def tri(angle, flip):
        s, c = math.sin(angle), math.cos(angle)
        px, py = (c, s) if not flip else (-c, -s)
        pts = [(-1.0, 0.0), (1.0, 0.0), (0.0, 0.5)]
        return shapes.Polygon.from_vertices(
            [(c * x - s * y + px, s * x + c * y + py) for x, y in pts])

    ship = wb.create_body(body_type=settings.DYNAMIC_BODY, position=(0.0, 2.0),
                          angle=math.pi, angular_damping=2.0, linear_damping=0.5,
                          allow_sleep=False)
    wb.create_fixture(ship, tri(0.3524 * math.pi, False), density=4.0)
    wb.create_fixture(ship, tri(-0.3524 * math.pi, True), density=2.0)
    for i in range(10):
        b = wb.create_body(body_type=settings.DYNAMIC_BODY,
                           position=(0.0, 5.0 + 1.54 * i))
        wb.create_fixture(b, shapes.Polygon.box(0.5, 0.5), density=1.0, friction=0.3)
        # a 1 x 1 box of density 1: m = 1, I = m * (1 + 1) / 12
        mass = 1.0
        inertia = mass * (1.0 ** 2 + 1.0 ** 2) / 12.0
        radius = math.sqrt(2.0 * inertia / mass)
        wb.create_friction_joint(ground, b, (0.0, 5.0 + 1.54 * i),
                                 max_force=mass * 10.0,
                                 max_torque=mass * radius * 10.0,
                                 collide_connected=True)
    return wb.freeze(device=device, **capacity)


def many_bodies(n=10000, spacing=2.2, device="cuda", **capacity):
    """Testbed/Tests/ManyBodies.h analog: n small boxes in a sparse falling
    grid over a wide ground, the broad-phase and scaling load (the
    reference runs up to 50k bodies, ManyBodies.h:335-427)."""
    wb = WorldBuilder(gravity=(0.0, -10.0))
    cols = int(math.ceil(math.sqrt(n)))
    half = 0.5 * cols * spacing + 10.0
    ground = wb.create_body()
    wb.create_fixture(ground, shapes.Edge((-half, 0.0), (half, 0.0)))
    box = shapes.Polygon.box(0.5, 0.5)
    for i in range(n):
        r, c = divmod(i, cols)
        b = wb.create_body(body_type=settings.DYNAMIC_BODY,
                           position=((c - 0.5 * cols) * spacing, 2.0 + r * spacing))
        wb.create_fixture(b, box, density=1.0, friction=0.3)
    return wb.freeze(device=device, **capacity)


def multithread_demo(n_boxes=2800, device="cuda", **capacity):
    """Testbed/Tests/MultithreadDemo.h analog: a container full of boxes
    (the reference's headline multithreaded load, MultithreadDemo.h:26)."""
    wb = WorldBuilder(gravity=(0.0, -10.0))
    ground = wb.create_body()
    wb.create_fixture(ground, shapes.Edge((-52.0, 0.0), (52.0, 0.0)))
    wb.create_fixture(ground, shapes.Edge((-52.0, 0.0), (-52.0, 120.0)))
    wb.create_fixture(ground, shapes.Edge((52.0, 0.0), (52.0, 120.0)))
    box = shapes.Polygon.box(0.5, 0.5)
    cols = 100
    for i in range(n_boxes):
        r, c = divmod(i, cols)
        b = wb.create_body(body_type=settings.DYNAMIC_BODY,
                           position=((c - 0.5 * cols) * 1.02 + 0.255 * (r % 2),
                                     1.02 + r * 1.02))
        wb.create_fixture(b, box, density=1.0, friction=0.3)
    return wb.freeze(device=device, **capacity)


def tiles(rows=20, ground_n=200, ground_m=10, device="cuda", **capacity):
    """Testbed/Tests/Tiles.h: a pyramid of boxes on a ground made of
    ground_n x ground_m square tile fixtures (the broad phase's
    fixture-count load)."""
    wb = WorldBuilder(gravity=(0.0, -10.0))
    a = 0.5
    ground = wb.create_body(position=(0.0, -a))
    y = 0.0
    for _ in range(ground_m):
        x = -ground_n * a
        for _ in range(ground_n):
            wb.create_fixture(ground, shapes.Polygon.box(a, a, (x, y), 0.0))
            x += 2.0 * a
        y -= 2.0 * a
    box = shapes.Polygon.box(a, a)
    x = (-7.0, 0.75)
    for i in range(rows):
        yv = x
        for _ in range(i, rows):
            b = wb.create_body(body_type=settings.DYNAMIC_BODY, position=yv)
            wb.create_fixture(b, box, density=5.0)
            yv = (yv[0] + 1.125, yv[1])
        x = (x[0] + 0.5625, x[1] + 1.25)
    return wb.freeze(device=device, **capacity)


def many_bodies_impl(floaters=60, bullets=0, sleepers=0, static_boxes=0,
                     static_edges=0, static_sensors=0, border=100.0,
                     speed_per_radius=8.0, thick_threshold=1.0,
                     min_static=2.0, max_static=10.0, thick_walls=True,
                     seed=0, device="cuda", **capacity):
    """ManyBodiesImpl analog (ManyBodies.h:70-313): zero gravity, a
    thick-walled border box, random static boxes, edges and sensors, and
    circle and polygon floaters launched at a speed proportional to their
    radius (bullets at 120 m/s, the least radius, density 25); sleepers
    start at rest, damped.

    Returns (state, aux): aux = {"target_speed": (1, N) f32, "floater":
    (1, N) bool} on the state's device, for `floater_drive`."""
    rng = random.Random(seed)
    wb = WorldBuilder(gravity=(0.0, 0.0))
    ground = wb.create_body()
    bw = 5.0
    for cx, cy, hx, hy in ((0.0, border, border, bw), (0.0, -border, border, bw),
                           (border, 0.0, bw, border), (-border, 0.0, bw, border)):
        wb.create_fixture(ground, shapes.Polygon.box(hx, hy, (cx, cy), 0.0),
                          thick_shape=thick_walls)
    pos_range = border - bw - max_static
    for _ in range(static_boxes):
        hx = rng.uniform(min_static, max_static)
        hy = rng.uniform(min_static, max_static)
        x = rng.uniform(-pos_range, pos_range)
        y = rng.uniform(-pos_range, pos_range)
        a = rng.uniform(0.0, 2.0 * math.pi)
        wb.create_fixture(ground, shapes.Polygon.box(hx, hy, (x, y), a),
                          thick_shape=thick_walls)
    for _ in range(static_sensors):
        x = rng.uniform(-pos_range, pos_range)
        y = rng.uniform(-pos_range, pos_range)
        wb.create_fixture(ground, shapes.Polygon.box(max_static, max_static, (x, y), 0.0),
                          is_sensor=True)
    for _ in range(static_edges):
        hx = rng.uniform(min_static, max_static)
        x = rng.uniform(-pos_range, pos_range)
        y = rng.uniform(-pos_range, pos_range)
        a = rng.uniform(0.0, 2.0 * math.pi)
        c, s = math.cos(a), math.sin(a)
        wb.create_fixture(ground, shapes.Edge((x - c * hx, y - s * hx),
                                              (x + c * hx, y + s * hx)))

    n_total = floaters + sleepers
    speeds, is_floater = [], []
    pos_range_f = border - bw
    for i in range(n_total):
        radius = rng.uniform(0.5, 5.0)
        speed = speed_per_radius * radius
        x = rng.uniform(-pos_range_f, pos_range_f)
        y = rng.uniform(-pos_range_f, pos_range_f)
        a = rng.uniform(0.0, 2.0 * math.pi)
        density = 1.0
        bullet = False
        if i < bullets:
            speed, radius, bullet, density = 120.0, 0.5, True, 25.0
        if i < floaters:
            nx, ny = rng.random(), rng.random()
            nl = math.sqrt(nx * nx + ny * ny) or 1.0
            vel = (speed * nx / nl, speed * ny / nl)
            lin_damp = 0.0
        else:
            vel, lin_damp, density = (0.0, 0.0), 0.5, 5.0
        b = wb.create_body(body_type=settings.DYNAMIC_BODY, position=(x, y),
                           angle=a, linear_velocity=vel, bullet=bullet,
                           linear_damping=lin_damp, angular_damping=0.25)
        if i % 2 == 0:
            shape = shapes.Circle(radius)
        else:
            nverts = max(3, min(i % settings.MAX_POLYGON_VERTICES, 8))
            arc = 2.0 * math.pi / nverts
            shape = shapes.Polygon.from_vertices(
                [(radius * math.cos((v + 1.0) * arc), radius * math.sin((v + 1.0) * arc))
                 for v in range(nverts)])
        wb.create_fixture(b, shape, density=density, thick_shape=radius > thick_threshold)
        speeds.append(speed if i < floaters else 0.0)
        is_floater.append(i < floaters)
    state = wb.freeze(device=device, **capacity)
    cap = state.bodies.capacity
    tspeed = np.zeros((1, cap), np.float32)
    fmask = np.zeros((1, cap), bool)
    tspeed[0, 1:1 + n_total] = speeds          # body 0 is the ground
    fmask[0, 1:1 + n_total] = is_floater
    dev = state.bodies.v.device
    return state, {"target_speed": torch.from_numpy(tspeed).to(dev),
                   "floater": torch.from_numpy(fmask).to(dev)}


def floater_drive(state, aux, dt, bullet_unbounded=True):
    """UpdateFloaterTask analog (ManyBodies.h:29-68), between steps: each
    floater accelerates toward its target speed along its velocity
    (non-bullets by at most speed * dt / 2, kAccelerationTime = 2). The
    impulse does not wake a body, so sleeping floaters keep still. Over
    the world axis; aux rows (W or 1, N); no host read."""
    b = state.bodies
    v = b.v
    speed = torch.sqrt((v * v).sum(-1))
    n = v / torch.clamp_min(speed, 1e-12)[..., None]
    tgt = aux["target_speed"]
    max_acc = torch.where(b.bullet & bullet_unbounded, tgt, tgt * dt * 0.5)
    acc = torch.minimum(torch.maximum(tgt - speed, -max_acc), max_acc)
    ok = aux["floater"] & b.awake & (b.body_type == settings.DYNAMIC_BODY)
    dv = torch.where(ok[..., None], acc[..., None] * n, 0.0)
    return dataclasses.replace(state, bodies=dataclasses.replace(b, v=v + dv))


def many_bodies_variant(k, device="cuda", **capacity):
    """The six ManyBodies stress parameterizations (ManyBodies.h:335-427),
    as the JAX package scales them (counts ~50x down; 1-2 pair churn, 3
    fixture sync, 4 island traversal, 5 SolveTOI, 6 reduced)."""
    kw = {1: dict(floaters=60, sleepers=240, static_boxes=30, border=150.0,
                  min_static=2.0, max_static=10.0),
          2: dict(floaters=60, bullets=12, sleepers=120, static_boxes=8,
                  static_edges=8, border=100.0, min_static=2.0, max_static=10.0),
          3: dict(floaters=200, border=150.0, speed_per_radius=20.0),
          4: dict(floaters=150, static_sensors=4, border=60.0, max_static=30.0),
          5: dict(floaters=60, bullets=12, static_edges=10, border=60.0,
                  min_static=10.0, max_static=30.0),
          6: dict(floaters=40, bullets=10, static_boxes=4, static_edges=4,
                  border=40.0, min_static=2.0, max_static=10.0)}
    if k not in kw:
        raise ValueError(k)
    return many_bodies_impl(**kw[k], device=device, **capacity)


def conveyor_belt(device="cuda", **capacity):
    """Testbed/Tests/ConveyorBelt.h — 5 boxes dropped on a static platform
    (fixture index 1). Drive it with a pre_solve_fn that returns
    tangent_speed=5 for the platform's contacts (the SetTangentSpeed
    analog, b2Contact.h:157)."""
    wb = WorldBuilder(gravity=(0.0, -10.0))
    ground = wb.create_body()
    wb.create_fixture(ground, shapes.Edge((-20.0, 0.0), (20.0, 0.0)))
    platform = wb.create_body(position=(-5.0, 5.0))
    wb.create_fixture(platform, shapes.Polygon.box(10.0, 0.5), friction=0.8)
    for i in range(5):
        b = wb.create_body(body_type=settings.DYNAMIC_BODY,
                           position=(-10.0 + 2.0 * i, 7.0))
        wb.create_fixture(b, shapes.Polygon.box(0.5, 0.5), density=20.0)
    return wb.freeze(device=device, **capacity)


def one_sided_platform(device="cuda", **capacity):
    """Testbed/Tests/OneSidedPlatform.h — circle dropped at -50 m/s onto a
    platform (fixture 1); pair it with a pre_solve_fn that disables the
    platform's contacts while the actor (body 2) is below the platform
    top."""
    wb = WorldBuilder(gravity=(0.0, -10.0))
    ground = wb.create_body()
    wb.create_fixture(ground, shapes.Edge((-20.0, 0.0), (20.0, 0.0)))
    platform = wb.create_body(position=(0.0, 10.0))
    wb.create_fixture(platform, shapes.Polygon.box(3.0, 0.5))
    actor = wb.create_body(body_type=settings.DYNAMIC_BODY,
                           position=(0.0, 12.0),
                           linear_velocity=(0.0, -50.0))
    wb.create_fixture(actor, shapes.Circle(0.5), density=20.0)
    return wb.freeze(device=device, **capacity)


def breakable(device="cuda", **capacity):
    """Testbed/Tests/Breakable.h — one body with two half-box fixtures
    dropped from 40 m; the reference splits it on hard impact via
    PostSolve + fixture destruction (mutate.remove_fixture/add_body).
    Four body slots, for the split piece, unless the caller passes
    others."""
    wb = WorldBuilder(gravity=(0.0, -10.0))
    g = wb.create_body()
    wb.create_fixture(g, shapes.Edge((-40.0, 0.0), (40.0, 0.0)))
    b = wb.create_body(body_type=settings.DYNAMIC_BODY,
                       position=(0.0, 40.0), angle=0.25 * math.pi)
    wb.create_fixture(b, shapes.Polygon.box(0.5, 0.5, (-0.5, 0.0), 0.0),
                      density=1.0)
    wb.create_fixture(b, shapes.Polygon.box(0.5, 0.5, (0.5, 0.0), 0.0),
                      density=1.0)
    return wb.freeze(device=device, **{"body_capacity": 4, **capacity})


def skier(device="cuda", **capacity):
    """Testbed/Tests/Skier.h — the collision-jerk regression: a skier
    (box torso + trapezoid ski, friction 0) slides from a platform onto
    two ghost-connected slope edges; crossing the slope joints must not
    kick the skier airborne."""
    a1 = 30.0 * math.pi / 180.0          # -Angle1Degrees, downward slope
    a2 = a1 + 10.0 * math.pi / 180.0     # relative second slope
    slope = 2.0
    verts = [(-8.0, 0.0), (0.0, 0.0)]
    verts.append((verts[-1][0] + slope * math.cos(a1),
                  verts[-1][1] - slope * math.sin(a1)))
    verts.append((verts[-1][0] + slope * math.cos(a2),
                  verts[-1][1] - slope * math.sin(a2)))
    wb = WorldBuilder(gravity=(0.0, -10.0))
    g = wb.create_body()
    for i in range(3):
        wb.create_fixture(g, shapes.Edge(
            verts[i], verts[i + 1],
            v0=verts[i - 1] if i > 0 else None,
            v3=verts[i + 2] if i < 2 else None), friction=0.2)
    body_w, body_h, ski_len, ski_t = 1.0, 2.5, 3.0, 0.3
    skier_b = wb.create_body(body_type=settings.DYNAMIC_BODY,
                             position=(-4.0, body_h / 2 + ski_t),
                             linear_velocity=(0.5, 0.0))
    wb.create_fixture(skier_b, shapes.Polygon.box(body_w / 2, body_h / 2),
                      density=1.0)
    ski = shapes.Polygon.from_vertices(
        [(-ski_len / 2 - ski_t, -body_h / 2),
         (-ski_len / 2, -body_h / 2 - ski_t),
         (ski_len / 2, -body_h / 2 - ski_t),
         (ski_len / 2 + ski_t, -body_h / 2)])
    wb.create_fixture(skier_b, ski, density=1.0, friction=0.0,
                      restitution=0.15)
    return wb.freeze(device=device, **capacity)


def shape_editing(device="cuda", **capacity):
    """Testbed/Tests/ShapeEditing.h — ground edge + one 4x4 dynamic box
    with spare fixture slots (four unless the caller passes others); the
    test attaches/detaches a circle fixture at runtime via
    mutate.add_fixture/remove_fixture (the 'C'/'D' keys) and toggles the
    sensor flag (the 'S' key)."""
    wb = WorldBuilder(gravity=(0.0, -10.0))
    g = wb.create_body()
    wb.create_fixture(g, shapes.Edge((-40.0, 0.0), (40.0, 0.0)))
    b = wb.create_body(body_type=settings.DYNAMIC_BODY, position=(0.0, 10.0))
    wb.create_fixture(b, shapes.Polygon.box(4.0, 4.0), density=10.0)
    return wb.freeze(device=device, **{"fixture_capacity": 4, **capacity})
