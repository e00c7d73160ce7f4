"""The seeded generator: the same seed gives the same inputs, another seed
others, and the pool that set-up builds world by world is what the
reference's builder makes of the same body lists."""

import numpy as np
import pytest
import torch

from benchmark import cells, harness
from benchmark.program import Program
from benchmark.reference.step import Reference
from benchmark.tests import bench_tiny

SCENE = cells.scene("pyramid")


def _offsets(layout_seed):
    return harness.draw_offsets(bench_tiny.cell(), bench_tiny.config(), SCENE, "cpu",
                                layout_seed=layout_seed)


def test_offsets_follow_the_layout_seed():
    big = 2**31 + 11
    a, b, c = _offsets(big), _offsets(big), _offsets(big + 1)
    assert a.shape == (3, SCENE.n_offsets(bench_tiny.config()))
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert np.abs(a).max() <= SCENE.OFFSET_MAX


def test_stream_seeds_differ_by_stream_and_seed():
    s = {harness.stream_seed(seed, k) for seed in (0, 1, 2**31 + 5)
         for k in ("offsets", "resets", "episodes")}
    assert len(s) == 9 and all(0 <= x < 2**63 for x in s)


def test_resets_follow_the_seed():
    cfg, cell = bench_tiny.config(), bench_tiny.cell()
    prog = Program("cpu")
    pool = prog.build_pool(SCENE, cfg, _offsets(5))

    def picks(seed):
        loop = harness.Loop(prog, pool, cell, dict(cfg["step"]), seed, "cpu")
        out = []
        for _ in range(3):
            loop._reset()
            out.append(loop.state.bodies.c.clone())
        return out

    a, b, c = picks(9), picks(9), picks(10)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, y) for x, y in zip(a, c))


def test_every_reset_holds_each_layout_as_often():
    """The seed orders the worlds; the work, the multiset of layouts, is
    the same in every episode of every run."""
    cfg, cell = bench_tiny.config(), bench_tiny.cell(worlds=7, variants=3)
    prog = Program("cpu")
    pool = prog.build_pool(SCENE, cfg, _offsets(5))
    firsts = pool.bodies.c[:, 1, 0]
    for seed in (1, 2**31 + 3):
        loop = harness.Loop(prog, pool, cell, dict(cfg["step"]), seed, "cpu")
        for _ in range(3):
            loop._reset()
            got = loop.state.bodies.c[:, 1, 0]
            counts = sorted(int((got == f).sum()) for f in firsts)
            assert counts == [2, 2, 3]


def test_pool_equals_the_reference_builders_pool():
    cfg = bench_tiny.config()
    off = _offsets(3)
    from benchmark import check
    prog_pool = Program("cpu").build_pool(SCENE, cfg, off)
    ref_pool = Reference("cpu").build_pool(SCENE, cfg, off)
    assert check.start_gap(prog_pool, ref_pool) < 1e-6
    # the boxes (bodies 1..n; body 0 is the ground) sit where the offsets put them
    nominal = Program("cpu").build_pool(SCENE, cfg, np.zeros_like(off))
    moved = (prog_pool.bodies.c - nominal.bodies.c)[:, 1:1 + off.shape[1]]
    assert torch.allclose(moved[..., 0].double(), torch.as_tensor(off), atol=1e-6)
    assert torch.equal(moved[..., 1], torch.zeros_like(moved[..., 1]))


def test_scene_refuses_a_wrong_offset_count():
    from benchmark.reference.step import LIB
    with pytest.raises(ValueError):
        SCENE.build(LIB, bench_tiny.config(), np.zeros(3))
