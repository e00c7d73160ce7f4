"""Scenes built with the port alone.

Same construction as `box2d_mt_tpu.models.scenes`, so the frozen states of
the two packages are equal field by field. States land on the card unless
the caller passes another `device` (the tests pass device="cpu"). The CCD
scenes take `WorldBuilder.freeze`'s capacities, so that they can share a
batch (`state.concat_worlds`)."""

import math
import random

from .. import settings, shapes
from ..world import WorldBuilder


def hello_world(device="cuda"):
    """HelloWorld.cpp:28-81 — ground box + one falling dynamic box."""
    wb = WorldBuilder(gravity=(0.0, -10.0))
    ground = wb.create_body(position=(0.0, -10.0))
    wb.create_fixture(ground, shapes.Polygon.box(50.0, 10.0))
    body = wb.create_body(body_type=settings.DYNAMIC_BODY, position=(0.0, 4.0))
    wb.create_fixture(body, shapes.Polygon.box(1.0, 1.0), density=1.0,
                      friction=0.3)
    return wb.freeze(device=device)


def pyramid(rows=10, device="cuda"):
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
    return wb.freeze(device=device)


def revolute_pendulum(device="cuda"):
    """Golden scene: box swinging on a revolute joint (golden.cpp)."""
    wb = WorldBuilder(gravity=(0.0, -10.0))
    ground = wb.create_body()
    body = wb.create_body(body_type=settings.DYNAMIC_BODY, position=(3.0, 10.0))
    wb.create_fixture(body, shapes.Polygon.box(0.5, 0.5), density=5.0)
    wb.create_revolute_joint(ground, body, (0.0, 10.0))
    return wb.freeze(device=device)


def prismatic_slide(device="cuda"):
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
    return wb.freeze(device=device)


def tumbler(n_boxes=200, device="cuda"):
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
    return wb.freeze(device=device)


def weld_pendulum(soft=False, device="cuda"):
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
    return wb.freeze(device=device)


def cantilever(n=8, device="cuda"):
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
    return wb.freeze(device=device)


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


def chain_links(n=30, device="cuda"):
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
    return wb.freeze(device=device)
