"""The reduction of a trace to the traced run's record, on a made-up
trace: busy time as the union of device intervals, idle gaps named by
the innermost host range open when they began, kernels by name; and
kineto events with or without an activity type."""

import types

import pytest
from torch.autograd import DeviceType

from benchmark import tracing


def _event(name, start, end, device, act):
    e = types.SimpleNamespace(name=lambda: name, start_ns=lambda: start,
                              duration_ns=lambda: end - start,
                              device_type=lambda: device)
    if act is not None:
        e.activity_type = lambda: act
    return e


def _prof(with_activity):
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    rows = [
        ("bench.step", 0, 100, cpu, "user_annotation"),
        ("span.collide", 10, 40, cpu, "user_annotation"),
        ("span.solve", 50, 90, cpu, "user_annotation"),
        ("span.collide", 12, 35, cuda, "gpu_user_annotation"),   # its device-side copy
        ("aten::add", 11, 12, cpu, "cpu_op"),
        ("cudaLaunchKernel", 12, 13, cpu, "cuda_runtime"),
        ("kernel_a", 20, 30, cuda, "kernel"),
        ("kernel_a", 25, 35, cuda, "kernel"),         # overlaps the first
        ("Memcpy DtoH", 60, 70, cuda, "gpu_memcpy"),
        ("kernel_b", 95, 120, cuda, "kernel"),        # runs past the span
        ("kernel_c", 150, 160, cuda, "kernel"),       # outside the span
    ]
    events = [_event(n, s, e, d, a if with_activity else None) for n, s, e, d, a in rows]
    return types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))


@pytest.mark.parametrize("with_activity", [True, False])
def test_summary_of_a_made_up_trace(with_activity):
    s = tracing.summarize(_prof(with_activity), n_steps=1)
    assert s["span_s"] == pytest.approx(100e-9)
    # union: [20, 35] + [60, 70] + [95, 100]
    assert s["busy_s"] == pytest.approx(30e-9)
    assert s["device_events"] == 4
    assert s["kernels"] == pytest.approx({"kernel_a": 20e-9, "Memcpy DtoH": 10e-9,
                                          "kernel_b": 25e-9})
    # gaps [0, 20] in the step, [35, 60] from collide (35-40) on, [70, 95] in solve
    assert s["idle"] == pytest.approx({"bench.step": 20e-9, "span.collide": 25e-9,
                                       "span.solve": 25e-9})


def test_empty_trace_reads_nothing():
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: [])))
    s = tracing.summarize(prof, n_steps=3)
    assert s["device_events"] == 0 and s["span_s"] == 0.0


def test_top_sorts_and_cuts():
    assert tracing.top({"a": 1.0, "b": 3.0, "c": 2.0}, n=2) == [["b", 3.0], ["c", 2.0]]


def test_a_span_whose_target_is_gone_stops_the_run():
    spans = tracing.Spans({"gone": {"wraps": ["benchmark.tracing:no_such_function"]}},
                          lambda: None)
    with pytest.raises(AttributeError):
        with spans.installed("split"):
            pass


def test_nested_spans_each_time_their_own_calls():
    """A span around a caller of another span's function leaves the
    inner span's time in place (each span counts its own outermost calls)."""
    import benchmark.tracing as mod

    def inner():
        return mod.top({"a": 1.0})

    mod._probe_inner = inner
    spans = tracing.Spans({"outer": {"wraps": ["benchmark.tracing:_probe_inner"]},
                           "inner": {"wraps": ["benchmark.tracing:top"]}}, lambda: None)
    try:
        with spans.installed("split"):
            mod._probe_inner()
    finally:
        del mod._probe_inner
    assert spans.seconds["outer"] > 0.0 and spans.seconds["inner"] > 0.0
    record = {"split": {"steps": 1, "wall_s": 1.0, "spans": spans.seconds}}
    from benchmark.metrics import span_ms
    assert span_ms(record, "inner") > 0.0 and span_ms(record, "gone") is None
