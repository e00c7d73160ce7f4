"""Counted device-to-host reads.

The JAX package keeps its data-dependent control flow on the device
(`lax.cond`, `lax.while_loop`). The eager port reads each such predicate
back to the host instead; every read waits for the device, so the step
counts them and reports the count in `Events.host_syncs`.

Shard threads (`parallel/sharding.py`) take turns on the host: a thread
runs a step holding the turn and hands it on for the length of each read,
so that the others launch while it waits, and no two threads pass the
GIL back and forth at every operation.
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


class HostSyncs:
    """Counter of device-to-host predicate reads for one step."""

    def __init__(self):
        self.count = 0

    def flag(self, t: torch.Tensor) -> bool:
        """One boolean predicate."""
        self.count += 1
        return _read(lambda: bool(t))

    def value(self, t: torch.Tensor) -> int:
        """One integer, such as a data-dependent loop bound."""
        self.count += 1
        return _read(lambda: int(t))

    def flags(self, *ts: torch.Tensor) -> list:
        """Several scalar predicates in a single transfer."""
        self.count += 1
        stacked = torch.stack([t.reshape(()) for t in ts])
        return [bool(x) for x in _read(stacked.tolist)]

    def values(self, t: torch.Tensor) -> list:
        """The integers of a 1-D tensor, in a single transfer."""
        self.count += 1
        return [int(x) for x in _read(t.tolist)]
