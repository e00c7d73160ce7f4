"""The port's large-world paths against the benchmark's plain reference.

The benchmark's MultithreadDemo scene (`benchmark/scenes/multithread_demo.py`,
the layout of the port's `models/scenes.py` `multithread_demo`: boxes of
half-size 0.5 in rows of 100, 1.02 m apart both ways, odd rows shifted
0.255 m, in a container of three edges) at 200 boxes in two worlds, frozen
at capacities (256, 2048, 4096) so that the grid pair finder (above 1024
fixture slots) and the Jones-Plassmann coloring (above 2048 contact slots)
run, as they do at the full 2800 boxes:

  * the benchmark's float64 Box2D reference follows the port step by step
    from the build through step 36, past the landing of both rows, within
    the limits of both of the benchmark's cells;
  * the counters `pairs.grid` and `coloring.jp_rounds` are above zero and
    equal the trips of the loops they count (a wrapper's calls of
    `find_pairs_grid`; one host read in b2.coloring a round, past the
    color cache's test of each step and the read that ends each
    coloring), and the reads by span sum to Events.host_syncs;
  * `island_labels` runs to its fixed point above 256 body slots, where
    the JAX package stops at 16 rounds: chains joined against their index
    order get the least index of their island, one host read a round.

Rows and side neighbours of the layout start 0.02 m apart, the two skins
at which b2CollidePolygons starts a manifold. So the scene moves each box
sideways by (-1)^column and up by (-1)^row times its own magnitude in 1-5
mm: every initial gap lies 2-10 mm off 0.02 m, and the two worlds differ.
"""

import numpy as np
import pytest
import torch

from benchmark import cells, check
from benchmark.program import Program
from benchmark.reference.step import Reference
from box2d_mt_tpu_torch import trace
from box2d_mt_tpu_torch.ops import broadphase, islands
from box2d_mt_tpu_torch.ops.sync import HostSyncs

BOXES, WORLDS = 200, 2
STEPS = 36          # the bottom row lands at step ~20, the second at ~21
SCENE = cells.scene("multithread_demo")
CONFIG = dict(cells.config("multithread2800"), boxes=BOXES, capacities=dict(
    body_capacity=256, fixture_capacity=2048, contact_capacity=4096))
COLUMNS = CONFIG["columns"]
STEP_KW = CONFIG["step"]
# the tighter of the two cells' limits, number by number
LIMITS = {k: min(cells.cell("pyramid20-w512-ep60")["limits"][k], v)
          for k, v in cells.cell("multithread2800-w16-ep120")["limits"].items()}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Two worlds wide: PyTorch's intra-op threads cost more than they
    give, and workers running side by side share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def roll(_one_thread):
    """The build and STEPS steps of two worlds inside `trace.collect()`,
    with the calls of `find_pairs_grid` counted through a wrapper."""
    u = np.random.default_rng(2**31 + 99).random((WORLDS, SCENE.n_offsets(CONFIG)))
    offsets = (2.0 * u - 1.0) * SCENE.OFFSET_MAX
    prog, ref = Program("cpu"), Reference("cpu")
    pool = prog.build_pool(SCENE, CONFIG, offsets)
    ref_pool = ref.build_pool(SCENE, CONFIG, offsets)
    grid_calls = []
    find_pairs_grid = broadphase.find_pairs_grid

    def counted(*args, **kwargs):
        grid_calls.append(1)
        return find_pairs_grid(*args, **kwargs)

    states, events, syncs = [pool], [], 0
    broadphase.find_pairs_grid = counted
    try:
        with trace.collect() as counts:
            for _ in range(STEPS):
                s, ev = prog.step(states[-1], STEP_KW)
                states.append(s)
                events.append(ev)
                syncs += ev.host_syncs
    finally:
        broadphase.find_pairs_grid = find_pairs_grid
    return dict(pool=pool, ref=ref, ref_pool=ref_pool, states=states, events=events,
                syncs=syncs, counts=counts, grid_calls=len(grid_calls))


def test_layout_keeps_every_initial_gap_off_the_manifold_threshold(roll):
    c = roll["ref_pool"].bodies.c[:, 1:].double()
    rows = c.reshape(WORLDS, BOXES // COLUMNS, COLUMNS, 2)
    side = rows[:, :, 1:, 0] - rows[:, :, :-1, 0] - 1.0
    up = rows[:, 1:, :, 1] - rows[:, :-1, :, 1] - 1.0
    for gap in (side, up):
        off = (gap - 0.02).abs()
        assert float(off.min()) >= 0.002 - 1e-9 and float(off.max()) <= 0.010 + 1e-9
    assert not torch.equal(c[0], c[1])


def test_reference_follows_the_port_past_the_landing(roll):
    values, seen = roll["ref"].follow(roll["states"], roll["events"], STEP_KW)
    values["start_gap"] = check.start_gap(roll["pool"], roll["ref_pool"])
    correct, compared = check.judge(values, LIMITS)
    assert correct, compared
    last = roll["states"][-1]
    # both rows stand on the ground and on each other
    assert int(last.contacts.touching.sum()) > 2 * BOXES
    assert all(int(ev.color_overflow.sum()) == 0 for ev in roll["events"])
    assert seen["order_fallback"] == 0
    # the check follows the fall and part of the landing
    assert seen["checked"] >= 0.5 * seen["world_steps"]


def test_counters_equal_the_trips_of_their_loops(roll):
    counts = roll["counts"]
    ev = counts.events
    assert counts.steps == STEPS
    assert sum(counts.reads.values()) == counts.host_syncs == roll["syncs"]
    assert ev["pairs.grid"] == roll["grid_calls"] > 0
    # b2.coloring reads the cache's flag each step, then one flag a JP
    # round and the one that ends each coloring
    assert ev["coloring.jp_rounds"] == (counts.reads["b2.coloring"] - STEPS
                                        - ev["coloring.runs"]) > 0
    assert ev["coloring.kernel"] == 0
    # b2.islands reads the label cache's flag each step, then one a round
    assert ev["islands.rounds"] == counts.reads["b2.islands"] - STEPS > 0


def _least_index_labels(n_bodies, chains):
    want = torch.arange(n_bodies, dtype=torch.int32)
    for chain in chains:
        want[chain] = min(chain)
    return want


@pytest.mark.parametrize("chains", [
    [list(range(40, 0, -1))],
    [list(range(299, 0, -1))],
    np.array_split(np.random.default_rng(7).permutation(np.arange(1, 299)), 2),
], ids=["reverse40", "reverse299", "two_shuffled"])
def test_island_labels_reach_their_fixed_point_past_256_slots(chains):
    """Chains in one 300-slot world, each link joining neighbours of the
    chain's order: every body of a chain gets its least index, however
    many rounds it takes."""
    n_bodies = 300
    chains = [[int(i) for i in ch] for ch in chains]
    a = torch.tensor([[i for ch in chains for i in ch[:-1]]], dtype=torch.int32)
    b = torch.tensor([[j for ch in chains for j in ch[1:]]], dtype=torch.int32)
    active = torch.ones(a.shape, dtype=torch.bool)
    connectable = torch.zeros((1, n_bodies), dtype=torch.bool)
    connectable[0, [i for ch in chains for i in ch]] = True
    syncs = HostSyncs()
    labels = islands.island_labels(n_bodies, a, b, active, connectable, syncs=syncs)
    assert torch.equal(labels[0], _least_index_labels(n_bodies, chains))
    longest = max(len(ch) for ch in chains)
    assert 2 <= syncs.events["islands.rounds"] == syncs.count <= longest
