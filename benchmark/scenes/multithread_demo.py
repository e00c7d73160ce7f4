"""Testbed/Tests/MultithreadDemo.h of Box2D-MT (2800 boxes, :26; stepped
1800 times in TestEntries.cpp:81-146) as the port lays it out
(`box2d_mt_tpu_torch.models.scenes.multithread_demo`): a container of three
static edges, 104 m wide and 120 m high, and `boxes` boxes of half-size
0.5, density 1 and friction 0.3 in rows of `columns`, 1.02 m apart both
ways, the odd rows shifted right by 0.255 m. The published scene is a
fountain; this grid is the analog the port's scene zoo carries.

The benchmark's one change: every box is moved by its own offset, so that
the worlds of a batch start from different layouts. The grid puts side
neighbours 0.02 m apart and rows 0.02 m apart, and the rows fall in lock
step until the bottom row lands: 0.02 m is exactly twice b2_polygonRadius,
where b2CollidePolygons starts a manifold. An offset drawn as the
pyramid's (uniform in +-OFFSET_MAX) would leave some gaps within a
rounding of that threshold, and the check leaves out every world-step
with a collider's decision that close. So the signs alternate: a box of
column c moves sideways by (-1)^c times its magnitude and a box of row r
moves up by (-1)^r times another, each magnitude uniform in
[MIN_OFFSET, OFFSET_MAX] (1 to 5 mm). Side neighbours and vertical
neighbours (which always lie in rows of other parity) then move apart or
together by the sum of two magnitudes, so every initial gap lies 2 to 10
mm off 0.02 m, while no two worlds are alike. The offsets the harness
draws, uniform in +-OFFSET_MAX, give the magnitudes:
MIN_OFFSET + |u| (OFFSET_MAX - MIN_OFFSET) / OFFSET_MAX."""

import numpy as np

# the largest and least offset, m: each gap of 0.02 m moves by 2 to 10 mm,
# so none closes and none lies within 1 mm of 0.02 m
OFFSET_MAX = 0.005
MIN_OFFSET = 0.001


def n_offsets(config) -> int:
    """How many offsets one world takes: two a box (sideways, then up),
    the sideways ones first, in creation order."""
    return 2 * config["boxes"]


def layout(config, offsets):
    """(boxes, 2) float64 centers of the boxes from one row of offsets."""
    offsets = np.asarray(offsets, np.float64)
    n = config["boxes"]
    if offsets.shape != (n_offsets(config),):
        raise ValueError(f"multithread_demo: {n_offsets(config)} offsets, got {offsets.shape}")
    mag = MIN_OFFSET + np.abs(offsets) * ((OFFSET_MAX - MIN_OFFSET) / OFFSET_MAX)
    cols = config["columns"]
    r, c = np.divmod(np.arange(n), cols)
    pitch, shift = config["pitch"], config["row_shift"]
    x = (c - 0.5 * cols) * pitch + shift * (r % 2) + np.where(c % 2 == 0, 1.0, -1.0) * mag[:n]
    y = config["first_row"] + r * pitch + np.where(r % 2 == 0, 1.0, -1.0) * mag[n:]
    return np.stack([x, y], 1)


def build(lib, config, offsets):
    """One world through `lib.WorldBuilder`, `lib` being the package under
    test or the frozen reference (each has WorldBuilder, shapes and
    settings); positions are summed in float64 and rounded by the builder."""
    centers = layout(config, offsets)
    wb = lib.WorldBuilder(gravity=tuple(config["gravity"]))
    ground = wb.create_body()
    for e in config["edges"]:
        wb.create_fixture(ground, lib.shapes.Edge((e[0], e[1]), (e[2], e[3])))
    h = config["box_half_size"]
    box = lib.shapes.Polygon.box(h, h)
    for x, y in centers:
        b = wb.create_body(body_type=lib.settings.DYNAMIC_BODY, position=(float(x), float(y)))
        wb.create_fixture(b, box, density=config["density"], friction=config["friction"])
    return wb
