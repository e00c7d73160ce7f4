"""The step's spans and counters (box2d_mt_tpu_torch/trace.py, ops/sync.py).

On pyramid(3) in two worlds, steps 7-12: first contact, pair refreshes,
colorings and TOI rounds, with one TOI sub-step at step 12.

  * Under `torch.profiler` each step is one `b2.step` holding the spans
    that trace.py's docstring lists, nested as it lists them, on the
    host's timeline alone; without a profiler no range is opened.
  * Inside `trace.collect()` each event counter equals a count taken
    through a wrapper of the function it counts, and the reads by span
    sum to the steps' Events.host_syncs. On the CPU no sub-step launches
    K8 ("toi.substep_kernel" 0); on a card (gpu marker) every sub-step
    launches it once.
  * Two CPU shards count what their worlds count stepped unsharded, and
    collectors add exactly under threads.
"""

import os
import sys
import threading

import pytest
import torch

from box2d_mt_tpu_torch import trace, world
from box2d_mt_tpu_torch.models import scenes
from box2d_mt_tpu_torch.ops import broadphase, coloring
from box2d_mt_tpu_torch.ops import toi as ktoi
from box2d_mt_tpu_torch.ops.sync import HostSyncs
from box2d_mt_tpu_torch.ops.toi import time_of_impact_lanes
from box2d_mt_tpu_torch.parallel import sharding
from box2d_mt_tpu_torch.state import map_leaves, replicate
from box2d_mt_tpu_torch.world import step_batched

DT = 1.0 / 60.0
CPU = torch.device("cpu")
FIRST, STEPS = 7, 6          # pyramid(3)'s first contact is at step 7

# each span's parent; the step's children that every awake step has
PARENT = {"b2.pairs": "b2.step", "b2.collide": "b2.step", "b2.pre_solve_hook": "b2.step",
          "b2.touch": "b2.step", "b2.islands": "b2.step", "b2.coloring": "b2.step",
          "b2.prepare": "b2.step", "b2.solve": "b2.step", "b2.post_solve": "b2.step",
          "b2.pair_refresh": "b2.post_solve", "b2.toi": "b2.step",
          "b2.toi_round": "b2.toi", "b2.toi_substep": "b2.toi"}
EVERY_STEP = ("b2.pairs", "b2.collide", "b2.touch", "b2.islands", "b2.coloring",
              "b2.prepare", "b2.solve", "b2.post_solve", "b2.toi")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def start():
    states = replicate(scenes.pyramid(3, device="cpu"), 2)
    for _ in range(FIRST):
        states, _ = step_batched(states, DT)
    return states


def _roll(states, n=STEPS, **kw):
    syncs = 0
    for _ in range(n):
        states, ev = step_batched(states, DT, **kw)
        syncs += ev.host_syncs
    return states, syncs


def _ranges(prof):
    """(name, start, end) of the trace's b2.* ranges, by start; each is a
    host range of function scope, no user annotation."""
    out = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events() if e.name().startswith("b2.")]
    assert not any(e.is_user_annotation() for e in prof.profiler.kineto_results.events()
                   if e.name().startswith("b2."))
    return sorted(out, key=lambda r: (r[1], -r[2]))


def _parents(ranges):
    """Each range with the innermost range that holds it (None: none)."""
    stack, out = [], []
    for name, s, e in ranges:
        while stack and stack[-1][2] <= s:
            stack.pop()
        parent = stack[-1] if stack else None
        assert parent is None or e <= parent[2], f"{name} crosses the end of {parent[0]}"
        out.append((name, parent[0] if parent else None))
        stack.append((name, s, e))
    return out


@pytest.mark.parametrize("hook", [False, True])
def test_each_step_is_one_b2_step_with_its_spans_nested(start, hook):
    from torch.profiler import ProfilerActivity, profile
    kw = {"pre_solve_fn": lambda states, view: {}} if hook else {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _roll(start, **kw)
    pairs = _parents(_ranges(prof))
    assert [n for n, p in pairs if n == "b2.step"] == ["b2.step"] * STEPS
    assert all(p is None for n, p in pairs if n == "b2.step")
    for name, parent in pairs:
        if name != "b2.step":
            assert PARENT[name] == parent, (name, parent)
    seen = {}
    for name, _ in pairs:
        seen[name] = seen.get(name, 0) + 1
    for name in EVERY_STEP:
        assert seen[name] == STEPS, name
    assert seen.get("b2.pre_solve_hook", 0) == (STEPS if hook else 0)
    # the stretch refreshes pairs and steps TOI rounds and one sub-step
    assert seen["b2.pair_refresh"] > 0 and seen["b2.toi_round"] >= STEPS
    assert seen["b2.toi_substep"] > 0


def test_no_range_without_a_profiler(start, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a profiler range without a profiler")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    with trace.collect() as counts:
        _roll(start)
    assert counts.steps == STEPS and counts.reads.keys() <= {"b2.step", *PARENT}


def test_counters_equal_the_counts_of_wrappers(start, monkeypatch):
    calls = {"coloring": 0, "toi": 0, "post_solve_pairs": 0}
    in_post_solve = []
    color_constraints, find_pairs = coloring.color_constraints, broadphase.find_pairs
    post_solve = world._post_solve_b

    def counted_coloring(*args, **kwargs):
        calls["coloring"] += 1
        return color_constraints(*args, **kwargs)

    def counted_find_pairs(*args, **kwargs):
        calls["post_solve_pairs"] += bool(in_post_solve)
        return find_pairs(*args, **kwargs)

    def marked_post_solve(*args, **kwargs):
        in_post_solve.append(True)
        try:
            return post_solve(*args, **kwargs)
        finally:
            in_post_solve.pop()

    def counted_toi(*args):
        calls["toi"] += 1
        return time_of_impact_lanes(*args)

    substep_plain = ktoi.toi_substep_passes_plain

    def counted_substep(*args, **kwargs):
        calls["substep"] = calls.get("substep", 0) + 1
        return substep_plain(*args, **kwargs)

    monkeypatch.setattr(coloring, "color_constraints", counted_coloring)
    monkeypatch.setattr(broadphase, "find_pairs", counted_find_pairs)
    monkeypatch.setattr(world, "_post_solve_b", marked_post_solve)
    monkeypatch.setattr(ktoi, "toi_substep_passes_plain", counted_substep)
    with trace.collect() as counts:
        _, syncs = _roll(start, toi=counted_toi)
    # every label pass runs to its fixed point below 257 bodies, one read a
    # round past the label cache's test of each step; no grid, no JP tier
    assert counts.events == {"coloring.runs": calls["coloring"],
                             "coloring.kernel": 0,
                             "coloring.jp_rounds": 0,
                             "islands.rounds": counts.reads["b2.islands"] - STEPS,
                             "pairs.refreshes": calls["post_solve_pairs"],
                             "pairs.grid": 0,
                             "toi.rounds": calls["toi"],
                             "toi.substep_kernel": 0}
    assert counts.events["islands.rounds"] > 0
    assert min(calls.values()) > 0, calls
    assert counts.steps == STEPS
    assert sum(counts.reads.values()) == counts.host_syncs == syncs
    # the coloring's own loops read inside b2.coloring, K2's selection in
    # b2.toi_round
    assert counts.reads["b2.coloring"] > calls["coloring"]
    assert counts.reads["b2.toi_round"] == calls["toi"]


def test_two_cpu_shards_count_what_their_worlds_count_unsharded(start):
    halves = [map_leaves(lambda t, i=i: t[i:i + 1], start) for i in range(2)]
    with trace.collect() as alone:
        for half in halves:
            _roll(half, n=3)
    step, shard = sharding.make_sharded_step([CPU, CPU])
    try:
        st = shard(start)
        with trace.collect() as sharded:
            for _ in range(3):
                st, _ = step(st, DT)
    finally:
        step.close()
    assert sharded.as_dict() == alone.as_dict()
    assert sharded.steps == 6 and sharded.events["toi.rounds"] > 0


def test_collectors_add_exactly_under_threads():
    """More threads than this machine's cores merge at once, with the
    interpreter switching threads every microsecond: no count is lost."""
    syncs = HostSyncs()
    with syncs.span("step"):
        syncs.flag(torch.tensor(True))
        syncs.event("toi.rounds")

    def merge():
        for _ in range(2000):
            trace.merge(syncs)

    n_threads = 2 * (os.cpu_count() or 4)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with trace.collect() as outer:
            with trace.collect() as inner:
                threads = [threading.Thread(target=merge) for _ in range(n_threads)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=60)
                assert not any(t.is_alive() for t in threads)
            trace.merge(syncs)
    finally:
        sys.setswitchinterval(interval)
    n = n_threads * 2000
    assert inner.as_dict() == {"steps": n, "host_syncs": n, "reads": {"b2.step": n},
                               "events": {"coloring.runs": 0, "coloring.kernel": 0,
                                          "coloring.jp_rounds": 0, "islands.rounds": 0,
                                          "pairs.refreshes": 0, "pairs.grid": 0,
                                          "toi.rounds": n, "toi.substep_kernel": 0}}
    assert outer.steps == n + 1
    trace.merge(syncs)          # no collector open: nothing to add to
    assert outer.steps == n + 1


@pytest.mark.gpu
def test_each_substep_launches_the_substep_kernel_once_on_a_card():
    """On a card every TOI sub-step's passes are one launch of K8: the
    event "toi.substep_kernel" equals the launches taken, and the plain
    version never runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on a card")
    launch, plain = ktoi._substep_launch, ktoi.toi_substep_passes_plain
    taken = []

    def counted_launch(*args):
        taken.append(1)
        return launch(*args)

    def refused(*args, **kwargs):
        raise AssertionError("the plain version ran on a card")

    states = replicate(scenes.pyramid(3, device="cuda"), 2)
    ktoi._substep_launch, ktoi.toi_substep_passes_plain = counted_launch, refused
    try:
        with trace.collect() as counts:
            _roll(states, n=FIRST + STEPS)
    finally:
        ktoi._substep_launch, ktoi.toi_substep_passes_plain = launch, plain
    assert len(taken) > 0
    assert counts.events["toi.substep_kernel"] == len(taken)
    assert counts.reads.get("b2.toi_substep", 0) == 0    # no read of a rank bound
