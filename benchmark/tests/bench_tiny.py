"""A tiny cell for the CPU tests: pyramid(4) in four worlds, 20-step
episodes, with the repository's pyramid20 settings otherwise."""

import time

from benchmark import cells, harness

CELL = "pyramid20-w512-ep60"


def config(rows=4):
    n = rows * (rows + 1) // 2 + 1
    cap = max(8, 1 << (n - 1).bit_length())
    return dict(cells.config("pyramid20"), rows=rows,
                capacities=dict(body_capacity=cap, fixture_capacity=cap, contact_capacity=4 * cap))


def cell(**over):
    c = dict(cells.cell(CELL), worlds=4, episode_steps=20, variants=3)
    c.update(over)
    return c


def run(seed=2**31 + 7, seconds=0.5, traced=False, timed=None, reference=None, rows=4, **over):
    bench = cells.benchmark()
    return harness.run_cell(cell(**over), config(rows), cells.metrics_of(bench, CELL, traced),
                            seed, seconds, traced, time.perf_counter(), "cpu",
                            timed=timed, reference=reference, log=lambda s: None)
