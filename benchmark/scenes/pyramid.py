"""Testbed/Tests/Pyramid.h of Box2D 2.3.x as carried by Box2D-MT
(TestEntries.cpp:81-146): an edge ground from -40 to 40 and `rows` rows of
boxes of half-size 0.5 and density 5, each row starting (0.5625, 1.25)
from the last and its boxes (1.125, 0) apart.

The benchmark's one change: every box is moved sideways by its own offset
(`offsets`, one a box in creation order), so that the worlds of a batch
start from different layouts."""

import numpy as np

# the largest offset, m: under half the 0.125 m gap between the boxes of a
# row, so no box starts touching a neighbour and every stack stands
OFFSET_MAX = 0.05


def n_offsets(config) -> int:
    """How many offsets one world takes: one a box."""
    rows = config["rows"]
    return rows * (rows + 1) // 2


def build(lib, config, offsets):
    """One world through `lib.WorldBuilder`, `lib` being the package under
    test or the frozen reference (each has WorldBuilder, shapes and
    settings). Positions are summed in float64, as the C++ test sums its
    float32 vectors into b2BodyDef.position, and the builder rounds them."""
    offsets = np.asarray(offsets, np.float64)
    if offsets.shape != (n_offsets(config),):
        raise ValueError(f"pyramid: {n_offsets(config)} offsets, got {offsets.shape}")
    wb = lib.WorldBuilder(gravity=tuple(config["gravity"]))
    ground = wb.create_body()
    g = config["ground"]
    wb.create_fixture(ground, lib.shapes.Edge((g[0], g[1]), (g[2], g[3])))
    h = config["box_half_size"]
    box = lib.shapes.Polygon.box(h, h)
    x, dx, dy = config["first_box"], config["row_step"], config["box_step"]
    k = 0
    for i in range(config["rows"]):
        y = tuple(x)
        for _ in range(i, config["rows"]):
            b = wb.create_body(body_type=lib.settings.DYNAMIC_BODY,
                               position=(y[0] + float(offsets[k]), y[1]))
            wb.create_fixture(b, box, density=config["density"],
                              friction=config["friction"])
            y = (y[0] + dy[0], y[1] + dy[1])
            k += 1
        x = (x[0] + dx[0], x[1] + dx[1])
    return wb
