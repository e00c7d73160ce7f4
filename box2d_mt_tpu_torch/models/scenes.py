"""Scenes built with the port alone.

Same construction as `box2d_mt_tpu.models.scenes`, so the frozen states of
the two packages are equal field by field. States land on the card unless
the caller passes another `device` (the tests pass device="cpu")."""

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
