"""Counted device-to-host reads.

The JAX package keeps its data-dependent control flow on the device
(`lax.cond`, `lax.while_loop`). The eager port reads each such predicate
back to the host instead; every read waits for the device, so the step
counts them and reports the count in `Events.host_syncs`.

Shard threads (`parallel/sharding.py`) take turns on the host: a thread
runs a step holding the turn and hands it on for the length of each read,
so that the others launch while it waits, and no two threads pass the
GIL back and forth at every operation.

The same object marks the step's phases (`HostSyncs.span`): each read is
put to the innermost span open when it happens, and under
`torch.profiler` each span is a range named `b2.<name>` (see
`box2d_mt_tpu_torch.trace`).
"""

import contextlib
import threading

import torch

_turn = threading.local()


@contextlib.contextmanager
def taking_turns(lock: threading.Lock):
    """Run the block holding `lock`, handing it to the other threads for
    the length of every counted host read in the block."""
    with lock:
        _turn.lock = lock
        try:
            yield
        finally:
            _turn.lock = None


def _read(fn):
    lock = getattr(_turn, "lock", None)
    if lock is None:
        return fn()
    lock.release()
    try:
        return fn()
    finally:
        lock.acquire()


PREFIX = "b2."


def _range(name: str):
    """A profiler range of function scope, as an operator's: the profiler
    keeps it on the host alone. (A `record_function` range is a user
    annotation, which the profiler also copies onto the device's
    timeline, where a trace reader that sees no activity types takes it
    for device work.)"""
    return torch._C._profiler._RecordFunctionFast(name)


class HostSyncs:
    """Counter of device-to-host predicate reads for one step, in all
    (`count`) and by the span open at each (`reads`, keyed by the span's
    range name; None outside every span), and of the step's events
    (`events`, counted at host branches with no read of their own)."""

    def __init__(self):
        self.count = 0
        self.reads = {}
        self.events = {}
        self.open = None

    def _counted(self):
        self.count += 1
        self.reads[self.open] = self.reads.get(self.open, 0) + 1

    def event(self, name: str):
        """One occurrence of the event `name`, such as "coloring.runs"."""
        self.events[name] = self.events.get(name, 0) + 1

    @contextlib.contextmanager
    def span(self, name: str):
        """The block is the span `b2.<name>`: the reads in it, outside the
        spans nested in it, are its own; under `torch.profiler` it is a
        range of that name."""
        outer = self.open
        self.open = PREFIX + name
        try:
            if torch.autograd._profiler_enabled():
                with _range(self.open):
                    yield
            else:
                yield
        finally:
            self.open = outer

    def flag(self, t: torch.Tensor) -> bool:
        """One boolean predicate."""
        self._counted()
        return _read(lambda: bool(t))

    def value(self, t: torch.Tensor) -> int:
        """One integer, such as a data-dependent loop bound."""
        self._counted()
        return _read(lambda: int(t))

    def flags(self, *ts: torch.Tensor) -> list:
        """Several scalar predicates in a single transfer."""
        self._counted()
        stacked = torch.stack([t.reshape(()) for t in ts])
        return [bool(x) for x in _read(stacked.tolist)]

    def values(self, t: torch.Tensor) -> list:
        """The integers of a 1-D tensor, in a single transfer."""
        self._counted()
        return [int(x) for x in _read(t.tolist)]
