"""A profiler trace put down to the program's own spans (`b2.*`).

The program opens a profiler range for each phase of `step_batched`
(box2d_mt_tpu_torch/trace.py). Each device event (kernel,
copy or memset) is linked by its correlation id to the runtime call that
launched it, and that call is put to the innermost `b2.*` range open on
its thread when it began. For each span:

    calls      ranges of that name
    host_s     their host time; self_s less the time of the b2.* ranges
               nested directly in them
    device_s   device time of the events launched while it was innermost;
    device_events  their count
    reads      counted host reads (from `trace.collect()`'s counts, when
               given)
    idle_s     device idle time in gaps that began while it was innermost
               on the stepping thread

Two rows more: `outside`, device events launched in no b2.* span (and
idle gaps that began in none), and `unattributed`, device events with no
link to a launch.

A range is any host event of that name: the program's spans are ranges
of function scope, the harness's `bench.step` a user annotation. Thread
ids: a host range may carry PyTorch's own thread id and a runtime call
the system's; a call linked to a PyTorch op takes the op's thread, and
the system thread of such calls maps the unlinked ones (a kernel launched
through ctypes). Where only one thread has b2.* ranges, every call is put
to it.
"""

import bisect
import re

from torch.autograd import DeviceType

PREFIX = "b2."
STEP = PREFIX + "step"
DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH = ("cuda_runtime", "cuda_driver")
HOST = ("cpu_op", "user_annotation")
RUNTIME = re.compile(r"cu(da)?[A-Z]")       # cudaLaunchKernel, cuLaunchKernel, ...
OUTSIDE, UNATTRIBUTED = "outside", "unattributed"


class Event:
    """What the reduction reads of one kineto event."""

    __slots__ = ("kind", "name", "start", "end", "thread", "corr", "linked")

    def __init__(self, kind, name, start, end, thread=0, corr=0, linked=0):
        self.kind, self.name, self.start, self.end = kind, name, start, end
        self.thread, self.corr, self.linked = thread, corr, linked


def _kind(e, name: str):
    """"device" for a kernel, copy or memset, "launch" for a runtime call,
    "host" for an operator's or a user's range, None for the rest. A trace
    without activity types (torch 2.11's kineto events): device events are
    those on a CUDA device less the copies of user annotations there, and
    runtime calls are known by name."""
    act = getattr(e, "activity_type", None)
    if act is not None:
        a = act()
        return ("device" if a in DEVICE else "launch" if a in LAUNCH
                else "host" if a in HOST else None)
    if e.device_type() == DeviceType.CUDA:
        return None if e.is_user_annotation() else "device"
    return "launch" if RUNTIME.match(name) else "host"


def events(prof) -> list:
    """The trace's events as `Event`s (see `_kind`)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        kind = _kind(e, e.name())
        if kind is None:
            continue
        s = e.start_ns()
        out.append(Event(kind, e.name(), s, s + e.duration_ns(), e.start_thread_id(),
                         e.correlation_id(), e.linked_correlation_id()))
    return out


def _change_points(ranges):
    """(times, names) at which the innermost of `ranges` (Events of one
    thread, nested) changes; None where none is open."""
    marks = sorted([(r.start, 1, -r.end, r.name) for r in ranges]
                   + [(r.end, 0, 0, r.name) for r in ranges])
    stack, times, names = [], [], []
    for t, is_start, _, name in marks:
        if is_start:
            stack.append(name)
        else:
            for j in range(len(stack) - 1, -1, -1):
                if stack[j] == name:
                    del stack[j]
                    break
        times.append(t)
        names.append(stack[-1] if stack else None)
    return times, names


def _at(points, t):
    times, names = points
    i = bisect.bisect_right(times, t) - 1
    return names[i] if i >= 0 else None


def _host_times(ranges, rows):
    """Calls, host and self seconds of each b2.* range name, per thread."""
    ranges = sorted(ranges, key=lambda r: (r.start, -r.end))
    stack = []          # [range, seconds of its direct children]
    done = []

    def close_until(t):
        while stack and stack[-1][0].end <= t:
            r, children = stack.pop()
            done.append((r, children))
            if stack:
                stack[-1][1] += r.end - r.start

    for r in ranges:
        close_until(r.start)
        stack.append([r, 0])
    close_until(float("inf"))
    for r, children in done:
        row = rows.setdefault(r.name, _row())
        row["calls"] += 1
        row["host_s"] += (r.end - r.start) * 1e-9
        row["self_s"] += (r.end - r.start - children) * 1e-9


def _row():
    return {"calls": 0, "host_s": 0.0, "self_s": 0.0, "device_s": 0.0,
            "device_events": 0, "reads": 0, "idle_s": 0.0}


def summarize(evs: list, counts: dict = None, step: str = STEP) -> dict:
    """{span: row} over the stretch from the first `step` range's start to
    the last one's end (see the module docstring); {} without one."""
    steps = [e for e in evs if e.kind == "host" and e.name == step]
    if not steps:
        return {}
    t0, t1 = min(e.start for e in steps), max(e.end for e in steps)
    ranges = {}
    for e in evs:
        if e.kind == "host" and e.name.startswith(PREFIX) and e.end > t0 and e.start < t1:
            ranges.setdefault(e.thread, []).append(e)
    rows = {}
    for thread_ranges in ranges.values():
        _host_times(thread_ranges, rows)
    points = {t: _change_points(r) for t, r in ranges.items()}
    stepping = max(ranges, key=lambda t: len(ranges[t])) if ranges else None

    # the thread of each launch: its op's, else its system thread's map
    ops = {e.corr: e for e in evs if e.kind == "host" and e.corr > 0}
    launches = {e.corr: e for e in evs if e.kind == "launch"}
    thread_of = {}
    for e in launches.values():
        op = ops.get(e.linked)
        if op is not None:
            thread_of.setdefault(e.thread, op.thread)

    def span_of(launch_thread, t):
        if len(points) == 1:
            thread = stepping
        else:
            thread = thread_of.get(launch_thread, launch_thread)
        return _at(points[thread], t) if thread in points else None

    dev = sorted((e for e in evs if e.kind == "device" and e.start < t1 and e.end > t0),
                 key=lambda e: e.start)
    for e in dev:
        launch = launches.get(e.corr)
        if launch is not None:
            name = span_of(launch.thread, launch.start) or OUTSIDE
        elif e.linked > 0 and e.linked in ops:
            op = ops[e.linked]
            name = (_at(points[op.thread], op.start) if op.thread in points else None) \
                or OUTSIDE
        else:
            name = UNATTRIBUTED
        row = rows.setdefault(name, _row())
        row["device_s"] += (e.end - e.start) * 1e-9
        row["device_events"] += 1

    # idle gaps of the union of device intervals, by the innermost span on
    # the stepping thread where each began
    merged = []
    for e in dev:
        s, x = max(e.start, t0), min(e.end, t1)
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], x)
        else:
            merged.append([s, x])
    edges = [t0] + [x for iv in merged for x in iv] + [t1]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 > g0:
            name = (_at(points[stepping], g0) if stepping in points else None) or OUTSIDE
            rows.setdefault(name, _row())["idle_s"] += (g1 - g0) * 1e-9

    for name, n in ((counts or {}).get("reads") or {}).items():
        rows.setdefault(name or OUTSIDE, _row())["reads"] += n
    return rows


def shares(rows: dict) -> dict:
    """The device time and events of b2.step's own self time, as shares of
    all that b2.* spans launched, and the unattributed share of the
    stretch's device time."""
    spans = [r for n, r in rows.items() if n.startswith(PREFIX)]
    dev_s = sum(r["device_s"] for r in spans)
    dev_n = sum(r["device_events"] for r in spans)
    all_s = sum(r["device_s"] for r in rows.values())
    step = rows.get(STEP, _row())
    return {"step_self_device": step["device_s"] / dev_s if dev_s else None,
            "step_self_events": step["device_events"] / dev_n if dev_n else None,
            "unattributed_device": (rows.get(UNATTRIBUTED, _row())["device_s"] / all_s
                                    if all_s else None)}


def device_ms(rows: dict, spans, steps: int):
    """Device ms a step launched in `spans`; None without rows or steps."""
    if not rows or not steps:
        return None
    return 1e3 * sum(rows.get(s, _row())["device_s"] for s in spans) / steps


def table(rows: dict, steps: int) -> list:
    """Lines of the table, a row a span, each number a step: calls, host
    ms, self ms, device ms, device events, reads, idle ms."""
    head = (f"{'span':<18}{'calls':>8}{'host ms':>10}{'self ms':>10}{'device ms':>11}"
            f"{'kernels':>9}{'reads':>8}{'idle ms':>10}")
    out = [head]
    order = sorted(rows, key=lambda n: (not n.startswith(PREFIX), -rows[n]["host_s"]))
    for name in order:
        r = rows[name]
        out.append(f"{name:<18}{r['calls'] / steps:>8.2f}{1e3 * r['host_s'] / steps:>10.3f}"
                   f"{1e3 * r['self_s'] / steps:>10.3f}{1e3 * r['device_s'] / steps:>11.3f}"
                   f"{r['device_events'] / steps:>9.1f}{r['reads'] / steps:>8.2f}"
                   f"{1e3 * r['idle_s'] / steps:>10.3f}")
    return out
