"""The trace put down to the program's spans (benchmark/by_span.py): a
made-up event list of host ranges, launches and device events with
correlation ids, one device event unlinked; the threads of ranges and of
launches told apart; and a profiled stretch of the tiny cell on the CPU,
whose host reads by span sum to its Events.host_syncs."""

import types

import pytest
from torch.autograd import DeviceType

from benchmark import by_span
from benchmark.by_span import Event

NS = 1e-9


def _trace():
    """One stepping thread (PyTorch id 1, system id 7777)."""
    r = lambda n, s, e: Event("host", n, s, e, thread=1)          # noqa: E731
    return [
        r("bench.step", 0, 100), r("b2.step", 5, 95), r("b2.collide", 10, 40),
        r("b2.toi", 50, 90), r("b2.toi_round", 55, 70),
        Event("host", "aten::add", 11, 13, thread=1, corr=100),
        # a launch of an op, one through ctypes (no op), the harness's copy
        # before the step and one in the step's own self time
        Event("launch", "cudaLaunchKernel", 12, 13, thread=7777, corr=1, linked=100),
        Event("launch", "cudaLaunchKernel", 60, 61, thread=7777, corr=2),
        Event("launch", "cudaMemcpyAsync", 3, 4, thread=7777, corr=3),
        Event("launch", "cudaLaunchKernel", 92, 93, thread=7777, corr=4),
        Event("device", "kernel_a", 20, 30, corr=1, linked=100),
        Event("device", "toi_kernel", 62, 75, corr=2),
        Event("device", "Memcpy HtoD", 4, 6, corr=3),
        Event("device", "kernel_c", 93, 99, corr=4),
        Event("device", "kernel_x", 80, 85, corr=99),           # no launch
        Event("device", "kernel_late", 150, 160, corr=5),       # past the stretch
    ]


def test_attribution_self_times_idle_and_unattributed():
    counts = {"reads": {"b2.collide": 2, "b2.toi_round": 3, "b2.step": 1}}
    rows = by_span.summarize(_trace(), counts, step="bench.step")
    assert rows["b2.step"]["calls"] == 1
    assert rows["b2.step"]["host_s"] == pytest.approx(90 * NS)
    assert rows["b2.step"]["self_s"] == pytest.approx((90 - 30 - 40) * NS)
    assert rows["b2.toi"]["self_s"] == pytest.approx((40 - 15) * NS)
    dev = {n: (r["device_s"], r["device_events"]) for n, r in rows.items() if r["device_events"]}
    assert dev == pytest.approx({"b2.collide": (10 * NS, 1), "b2.toi_round": (13 * NS, 1),
                                 "b2.step": (6 * NS, 1), "outside": (2 * NS, 1),
                                 "unattributed": (5 * NS, 1)})
    # gaps: [0, 4] and [99, 100] outside every span, [6, 20] in the step,
    # [30, 62] from collide on, [75, 80] and [85, 93] in toi
    idle = {n: r["idle_s"] for n, r in rows.items() if r["idle_s"]}
    assert idle == pytest.approx({"outside": 5 * NS, "b2.step": 14 * NS,
                                  "b2.collide": 32 * NS, "b2.toi": 13 * NS})
    assert {n: r["reads"] for n, r in rows.items() if r["reads"]} == counts["reads"]
    shares = by_span.shares(rows)
    assert shares["step_self_device"] == pytest.approx(6 / 29)
    assert shares["step_self_events"] == pytest.approx(1 / 3)
    assert shares["unattributed_device"] == pytest.approx(5 / 36)
    assert by_span.device_ms(rows, ("b2.toi", "b2.toi_round"), 1) == pytest.approx(13e-6)
    lines = by_span.table(rows, 1)
    assert len(lines) == 1 + len(rows) and lines[1].startswith("b2.step")


def test_launches_go_to_their_own_threads_span():
    """Two stepping threads: a ctypes launch (no op) from system thread
    8888 goes to PyTorch thread 2's span through the system thread of a
    launch of an op on 8888."""
    evs = [Event("host", "b2.step", 0, 100, thread=1), Event("host", "b2.solve", 10, 50, thread=1),
           Event("host", "b2.step", 0, 100, thread=2), Event("host", "b2.toi", 40, 90, thread=2),
           Event("host", "aten::mul", 41, 42, thread=2, corr=200),
           Event("launch", "cudaLaunchKernel", 41, 42, thread=8888, corr=1, linked=200),
           Event("launch", "cudaLaunchKernel", 45, 46, thread=8888, corr=2),
           Event("launch", "cudaLaunchKernel", 20, 21, thread=7777, corr=3),
           Event("host", "aten::add", 19, 22, thread=1, corr=300),
           Event("launch", "cudaLaunchKernel", 20, 21, thread=7777, corr=4, linked=300),
           Event("device", "k_mul", 50, 52, corr=1), Event("device", "toi_kernel", 52, 60, corr=2),
           Event("device", "k_solve", 30, 31, corr=3), Event("device", "k_add", 31, 32, corr=4)]
    rows = by_span.summarize(evs)
    assert rows["b2.toi"]["device_events"] == 2 and rows["b2.solve"]["device_events"] == 2
    assert rows["b2.step"]["calls"] == 2


@pytest.mark.parametrize("with_activity", [True, False])
def test_events_of_a_kineto_trace_and_nothing_without_a_step(with_activity):
    """With activity types, and without (torch 2.11: the device's copy of
    a user annotation known by its flag, runtime calls by name)."""
    def kineto(name, act, start, dur, tid=1, corr=0, linked=0):
        e = types.SimpleNamespace(
            name=lambda: name, start_ns=lambda: start, duration_ns=lambda: dur,
            start_thread_id=lambda: tid, correlation_id=lambda: corr,
            linked_correlation_id=lambda: linked,
            device_type=lambda: DeviceType.CUDA if act.startswith(("gpu", "kernel"))
            else DeviceType.CPU,
            is_user_annotation=lambda: act.endswith("user_annotation"))
        if with_activity:
            e.activity_type = lambda: act
        return e

    raw = [kineto("bench.step", "user_annotation", 0, 10),
           kineto("b2.step", "cpu_op", 0, 10, corr=3),
           kineto("bench.step", "gpu_user_annotation", 1, 5),
           kineto("aten::add", "cpu_op", 1, 1, corr=7), kineto("k", "kernel", 2, 3, corr=9),
           kineto("cudaLaunchKernel", "cuda_runtime", 1, 1, tid=5, corr=9, linked=7),
           kineto("Memset (Device)", "gpu_memset", 6, 1)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: raw)))
    evs = by_span.events(prof)
    assert [e.kind for e in evs] == ["host", "host", "host", "device", "launch", "device"]
    rows = by_span.summarize(evs, step="bench.step")
    assert rows["b2.step"]["device_events"] == 1 and rows["unattributed"]["device_events"] == 1
    assert by_span.summarize(evs) == by_span.summarize(evs, step="b2.step") != {}
    assert by_span.summarize(evs, step="no.such.range") == {}
    assert by_span.device_ms({}, ("b2.toi",), 60) is None


def test_reads_by_span_sum_to_the_host_syncs_of_a_cpu_stretch():
    import torch
    from benchmark import cells, harness
    from benchmark.program import Program
    from benchmark.tests import bench_tiny
    from benchmark.tools import spans
    from box2d_mt_tpu_torch.trace import collect
    torch.set_num_threads(1)
    cell, config = bench_tiny.cell(), bench_tiny.config()
    scene = cells.scene(config["scene"])
    timed = Program("cpu")
    pool = timed.build_pool(scene, config, harness.draw_offsets(cell, config, scene, "cpu"))
    loop = harness.Loop(timed, pool, cell, dict(config["step"]), 2**31 + 11, "cpu")
    loop.sampling = False
    for _ in range(12):
        loop.one_step()
    rec = spans.reduce(*spans.stretch(loop, 6, lambda: None, collect, on_card=False), 6)
    assert rec["counts"]["steps"] == 6
    assert rec["reads_by_span"] == rec["counts"]["host_syncs"] == rec["host_syncs"] > 0
    assert rec["by_span"]["b2.step"]["calls"] == 6
    assert set(rec["per_step"]) >= {"colorings_per_step", "pair_refreshes_per_step",
                                    "toi_rounds_per_step", "toi_device_ms"}
