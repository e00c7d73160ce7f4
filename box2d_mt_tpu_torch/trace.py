"""Where a step's time, host reads and launches go: the step's spans and
counters.

`step_batched` marks its phases as spans (`ops.sync.HostSyncs.span`).
Under `torch.profiler` each span is a range on the host's timeline, of
function scope as an operator's (no copy on the device's timeline), on
the same clock as the card's kernels, so every kernel, copy and idle gap
of a trace can be put down to the phase whose host code issued or
awaited it. Spans nest; the innermost open span is the cause. The spans
of one step are the children of its `b2.step`, on the thread that
stepped it:

    b2.step            all of step_batched
      b2.pairs         the start-of-step flags and the refresh of the
                       pairs of worlds a mutation marked
      b2.collide       the narrow phase (world._collide_b)
      b2.pre_solve_hook  the caller's pre_solve_fn, when one is given
      b2.touch         touch transitions and warm-start matching
      b2.islands       the label cache test and ops.islands.island_labels
      b2.coloring      the color cache test and ops.coloring.color_constraints
      b2.prepare       the contact prepare (world._pre_finish)
      b2.solve         the solve middle (K1) or the sandwich (K3-K6)
      b2.post_solve    sleep, AABB sync, the pair refresh's gate
        b2.pair_refresh  ops.broadphase.find_pairs and the carry-over
      b2.toi           the TOI phase (world._continuous)
        b2.toi_round     one round: K2 and the selection of its events
        b2.toi_substep   the sub-step of a round's events, mini islands in

`collect()` gathers, over the steps inside it, the counted host reads of
each span and the step's events:

    coloring.runs     color_constraints ran: the color cache missed
    coloring.kernel   color_constraints launched K7 (csrc/coloring.cu), the
                      joints' colorings included: on a card, every coloring
                      of at most 2048 slots; on the CPU, none
    coloring.jp_rounds  rounds of the Jones-Plassmann tier (more than 2048
                      slots), one host read each
    islands.rounds    propagation rounds of ops.islands.island_labels, one
                      host read each
    pairs.refreshes   the post-solve ran find_pairs: a fixture left its
                      fat AABB in some world
    pairs.grid        the step's calls of ops.broadphase.find_pairs_grid
                      (above 1024 fixture slots): the pair refresh, and the
                      start-of-step pass over the worlds a mutation marked
    toi.rounds        calls of the time-of-impact entry (K2)
    toi.substep_kernel  sub-steps whose passes launched K8 (csrc/toi.cu
                      `toi_substep_kernel`), one launch each: on a card,
                      every sub-step; on the CPU, none

Counting costs one check a step while no collector is open; the counts
are host integers, read at host branches the step takes anyway. Each
step adds its counts at its end under a lock, so the shard threads of
`parallel.sharding` each count their own steps.

An operator's use, on the steps they care about::

    from torch.profiler import ProfilerActivity, profile
    from box2d_mt_tpu_torch import step_batched, trace

    with trace.collect() as counts, \\
            profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(60):
            states, events = step_batched(states, 1 / 60)
    print(counts.as_dict())        # steps, host_syncs, reads by span, events
    prof.export_chrome_trace("steps.json")   # b2.* ranges beside the kernels

Without a profiler no range is opened; a span then only names the
phase that the next host reads are put to.
"""

import contextlib
import threading

EVENTS = ("coloring.runs", "coloring.kernel", "coloring.jp_rounds", "islands.rounds",
          "pairs.refreshes", "pairs.grid", "toi.rounds", "toi.substep_kernel")


class Counts:
    """The counts of the steps a `collect()` saw: `steps`, `host_syncs`
    (Events.host_syncs summed), `reads` ({span: counted host reads}, which
    sum to `host_syncs`) and `events` ({event: count}, every one of
    EVENTS present)."""

    def __init__(self):
        self.steps = 0
        self.host_syncs = 0
        self.reads = {}
        self.events = dict.fromkeys(EVENTS, 0)

    def add(self, syncs):
        self.steps += 1
        self.host_syncs += syncs.count
        for name, n in syncs.reads.items():
            self.reads[name] = self.reads.get(name, 0) + n
        for name, n in syncs.events.items():
            self.events[name] = self.events.get(name, 0) + n

    def as_dict(self) -> dict:
        return {"steps": self.steps, "host_syncs": self.host_syncs,
                "reads": dict(self.reads), "events": dict(self.events)}


_lock = threading.Lock()
_open = []          # the collectors open now, in any thread


@contextlib.contextmanager
def collect():
    """Gather the counts of every step that ends inside the block, from
    any thread; yields the `Counts`."""
    counts = Counts()
    with _lock:
        _open.append(counts)
    try:
        yield counts
    finally:
        with _lock:
            _open.remove(counts)


def merge(syncs):
    """Add one step's counts (its `HostSyncs`) to every open collector."""
    if _open:
        with _lock:
            for counts in _open:
                counts.add(syncs)
