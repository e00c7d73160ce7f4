"""Counted device-to-host reads.

The JAX package keeps its data-dependent control flow on the device
(`lax.cond`, `lax.while_loop`). The eager port reads each such predicate
back to the host instead; every read waits for the device, so the step
counts them and reports the count in `Events.host_syncs`.
"""

import torch


class HostSyncs:
    """Counter of device-to-host predicate reads for one step."""

    def __init__(self):
        self.count = 0

    def flag(self, t: torch.Tensor) -> bool:
        """One boolean predicate."""
        self.count += 1
        return bool(t)

    def value(self, t: torch.Tensor) -> int:
        """One integer, such as a data-dependent loop bound."""
        self.count += 1
        return int(t)

    def flags(self, *ts: torch.Tensor) -> list:
        """Several scalar predicates in a single transfer."""
        self.count += 1
        return [bool(x) for x in torch.stack([t.reshape(()) for t in ts]).tolist()]

    def values(self, t: torch.Tensor) -> list:
        """The integers of a 1-D tensor, in a single transfer."""
        self.count += 1
        return [int(x) for x in t.tolist()]
