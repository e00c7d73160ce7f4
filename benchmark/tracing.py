"""Spans around the program's layers, the recorded kernel calls, and the
reduction of a profiler trace to the traced run's record.

A span (spans/<name>.json) wraps functions of the program by module and
attribute; a run installs the spans its metric readers name, and a target
that is not there stops the run. It has two modes:
  * "range": a `torch.profiler.record_function` named `span.<name>`, not
    synchronized; the profiled stretch marks its phases so.
  * "split": each outermost call of the span's own functions between two
    synchronizations, its host time added to the span (the synchronized
    split, frozen from the builders' chip_smoke.phase_split); a call
    inside another span's is timed by both. It inflates the step, so it
    runs on steps of its own and is never an end-to-end number.
"""

import bisect
import contextlib
import importlib
import time

import torch
from torch.autograd import DeviceType

from .roofline import ArgInfo

STEP = "bench.step"
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
KEEP_VALUES = 1 << 22      # integer and bool arguments kept for the counts


class Spans:
    """Wrappers over the program's functions named by the span files."""

    def __init__(self, span_files: dict, sync):
        self.files, self.sync = span_files, sync
        self.seconds = {name: 0.0 for name in span_files}
        self.depth = {name: 0 for name in span_files}

    def _targets(self):
        for name, spec in self.files.items():
            for target in spec["wraps"]:
                mod_name, attr = target.split(":")
                mod = importlib.import_module(mod_name)
                if not hasattr(mod, attr):
                    raise AttributeError(f"span {name!r}: {target} is not in the program")
                yield name, mod, attr

    def _split(self, name, fn):
        def call(*args, **kwargs):
            if self.depth[name]:
                return fn(*args, **kwargs)
            self.sync()
            t0 = time.perf_counter()
            self.depth[name] += 1
            try:
                return fn(*args, **kwargs)
            finally:
                self.depth[name] -= 1
                self.sync()
                self.seconds[name] += time.perf_counter() - t0
        return call

    @staticmethod
    def _range(name, fn):
        def call(*args, **kwargs):
            with torch.profiler.record_function(f"span.{name}"):
                return fn(*args, **kwargs)
        return call

    @contextlib.contextmanager
    def installed(self, mode: str):
        saved = []
        try:
            for name, mod, attr in list(self._targets()):
                fn = getattr(mod, attr)
                saved.append((mod, attr, fn))
                setattr(mod, attr, self._split(name, fn) if mode == "split"
                        else self._range(name, fn))
            yield self
        finally:
            for mod, attr, fn in reversed(saved):
                setattr(mod, attr, fn)


class CallRecorder:
    """Wraps a kernel entry (step_batched's `middle=` or `toi=`) and keeps,
    for every call, each argument's shape and element size, and the values
    of its integer and bool tensors (references until `to_host`)."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, *args):
        self.calls.append(args)
        return self.fn(*args)

    @staticmethod
    def _info(a):
        if isinstance(a, torch.Tensor):
            keep = (not a.is_floating_point()) and a.numel() <= KEEP_VALUES
            return ArgInfo(tuple(a.shape), a.element_size(), a.cpu() if keep else None)
        return ArgInfo((), 0, a)

    def to_host(self):
        return [[self._info(a) for a in args] for args in self.calls]


def _kind(e, name):
    """"device" for a kernel, copy or memset, "range" for a host
    record_function range, None for the rest. Older kineto events carry no
    activity type: there the device events are those on a CUDA device, less
    the device-side copies of the benchmark's own ranges."""
    act = getattr(e, "activity_type", None)
    if act is not None:
        a = act()
        return "device" if a in DEVICE_ACTIVITIES else "range" if a == "user_annotation" else None
    ours = name.startswith(("span.", STEP))
    if e.device_type() == DeviceType.CUDA:
        return None if ours else "device"
    return "range" if ours else None


def _events(prof):
    """(kind, name, start_ns, end_ns) of the trace's device events and host
    ranges (see `_kind`)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        kind = _kind(e, name)
        if kind is None:
            continue
        if hasattr(e, "start_ns"):
            s, d = e.start_ns(), e.duration_ns()
        else:
            s, d = 1000 * e.start_us(), 1000 * e.duration_us()
        out.append((kind, name, s, s + d))
    return out


def _innermost(ranges):
    """Change points (t, name) of the innermost host range over time; the
    ranges of one thread nest."""
    marks = sorted([(s, 1, -e, n) for n, s, e in ranges] + [(e, 0, 0, n) for n, s, e in ranges])
    stack, points = [], []
    for t, is_start, _, name in marks:
        if is_start:
            stack.append(name)
        else:
            for j in range(len(stack) - 1, -1, -1):
                if stack[j] == name:
                    del stack[j]
                    break
        points.append((t, stack[-1] if stack else "between steps"))
    return points


def summarize(prof, n_steps: int) -> dict:
    """The profiled stretch's record: its steps, wall span (first step's
    start to last step's end), device events, busy time (the union of
    device intervals), kernel time by name and idle time by the host range
    open when each idle gap began."""
    events = _events(prof)
    steps = [(s, e) for k, n, s, e in events if k == "range" and n == STEP]
    if not steps:
        return {"steps": n_steps, "span_s": 0.0, "busy_s": 0.0, "device_events": 0,
                "kernels": {}, "idle": {}}
    t0, t1 = min(s for s, _ in steps), max(e for _, e in steps)
    dev = sorted((s, e, n) for k, n, s, e in events if k == "device" and s < t1 and e > t0)
    kernels = {}
    for s, e, n in dev:
        kernels[n] = kernels.get(n, 0.0) + (e - s) * 1e-9
    merged = []
    for s, e, _ in dev:
        s, e = max(s, t0), min(e, t1)
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged)
    points = _innermost([(n, s, e) for k, n, s, e in events
                         if k == "range" and e > t0 and s < t1])
    times = [t for t, _ in points]
    idle = {}
    edges = [t0] + [x for iv in merged for x in iv] + [t1]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        i = bisect.bisect_right(times, g0) - 1
        name = points[i][1] if i >= 0 else "between steps"
        idle[name] = idle.get(name, 0.0) + (g1 - g0) * 1e-9
    return {"steps": n_steps, "span_s": (t1 - t0) * 1e-9, "busy_s": busy * 1e-9,
            "device_events": len(dev), "kernels": kernels, "idle": idle}


def top(d: dict, n=10, width=120):
    return [[k[:width], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
