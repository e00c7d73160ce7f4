"""The MultithreadDemo configuration (configs/multithread2800.json) and its
cell: both builders build the same worlds, every initial gap of every
layout lies clear of 0.02 m, the configuration and cell are found by
name, and a traced CPU run of the scene at the large-world tiers takes
the grid pair finder and the Jones-Plassmann coloring."""

import time

import numpy as np
import pytest
import torch

from benchmark import cells, check, harness
from benchmark.program import Program
from benchmark.reference.step import LIB, Reference

CELL = "multithread2800-w16-ep120"
SCENE = cells.scene("multithread_demo")
BENCH = cells.benchmark()
CONFIG = cells.config("multithread2800")


def _offsets(config, variants, layout_seed=harness.LAYOUT_SEED):
    cell = dict(cells.cell(CELL), variants=variants)
    return harness.draw_offsets(cell, config, SCENE, "cpu", layout_seed=layout_seed)


def test_both_builders_build_the_same_worlds():
    config = dict(CONFIG, boxes=200, capacities=dict(body_capacity=256, fixture_capacity=256,
                                                     contact_capacity=1024))
    off = _offsets(config, 3, layout_seed=2**31 + 5)
    prog_pool = Program("cpu").build_pool(SCENE, config, off)
    ref_pool = Reference("cpu").build_pool(SCENE, config, off)
    # float32 against float64 masses and friction, nothing more
    assert check.start_gap(prog_pool, ref_pool) < 1e-7
    # the boxes sit where the layout puts them (body 0 is the container)
    want = np.stack([SCENE.layout(config, row) for row in off])
    got = prog_pool.bodies.c[:, 1:201].double().numpy()
    assert np.abs(got - want).max() < 1e-5


def _gaps(centers, config):
    """Every side gap (neighbours of a row) and every row gap (a box and
    each box of the row above that it overlaps), m."""
    n, cols = config["boxes"], config["columns"]
    size = 2.0 * config["box_half_size"]
    rows = centers.reshape(n // cols, cols, 2)
    side = (rows[:, 1:, 0] - rows[:, :-1, 0] - size).ravel()
    lo, hi = rows[:-1], rows[1:]
    dx = np.abs(lo[:, :, None, 0] - hi[:, None, :, 0])
    overlap = dx < size
    dy = lo[:, :, None, 1] - hi[:, None, :, 1]
    row = (np.abs(dy) - size)[overlap]
    assert overlap.sum(axis=(1, 2)).min() >= cols      # about two boxes above each box
    return side, row


def test_every_initial_gap_lies_at_least_1mm_off_the_manifold_threshold():
    off = _offsets(CONFIG, cells.cell(CELL)["variants"])
    threshold = 2.0 * 2.0 * 0.005                   # two skins of b2_polygonRadius
    for row in off:
        side, rows = _gaps(SCENE.layout(CONFIG, row), CONFIG)
        for gaps in (side, rows):
            assert np.abs(gaps - threshold).min() >= 1e-3
            assert gaps.min() > 0.0                 # no box starts overlapping another
    # the worlds differ
    layouts = [SCENE.layout(CONFIG, row) for row in off]
    assert all(not np.array_equal(layouts[0], x) for x in layouts[1:])


def test_the_scene_refuses_a_wrong_offset_count():
    with pytest.raises(ValueError):
        SCENE.build(LIB, CONFIG, np.zeros(3))


def test_the_configuration_and_cell_are_found_by_name():
    cell = cells.cell(CELL)
    assert (cell["config"], cell["worlds"], cell["episode_steps"], cell["variants"]) == \
        ("multithread2800", 16, 120, 16)
    entry = cells.cell_entry(BENCH, CELL)
    assert entry["chips"] == 1 and entry["traffic"] == cell["traffic"]
    assert CONFIG["reduced"] == [] and CONFIG["capacities"] == dict(
        body_capacity=4096, fixture_capacity=4096, contact_capacity=16384)
    assert SCENE.n_offsets(CONFIG) == 2 * 2800
    assert any(c["file"] == "benchmark/configs/multithread2800.json" for c in BENCH["configs"])


def test_a_traced_cpu_run_of_the_scene_takes_the_large_world_tiers():
    """200 boxes at the large-world tiers' capacities, in two worlds, 20-step
    episodes: the run is correct, its split stretch reads the step's
    spans, and the steps call the grid finder and the JP coloring."""
    from box2d_mt_tpu_torch import trace
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cell = dict(cells.cell(CELL), worlds=2, variants=2, episode_steps=20)
        config = dict(CONFIG, boxes=200, capacities=dict(
            body_capacity=256, fixture_capacity=2048, contact_capacity=4096))
        with trace.collect() as counts:
            r = harness.run_cell(cell, config, cells.metrics_of(BENCH, CELL, True),
                                 2**31 + 17, 0.1, True, time.perf_counter(), "cpu",
                                 log=lambda s: None)
    finally:
        torch.set_num_threads(n)
    assert r["correct"] and r["failed"] == 0
    for metric in ("graph_prep_ms", "post_solve_ms", "collide_ms", "host_syncs_per_step"):
        assert r["metrics"][metric]["value"] > 0.0
    assert counts.events["pairs.grid"] > 0 and counts.events["coloring.jp_rounds"] > 0
