"""Multi-world batching and sharding of the world axis over devices.

Port of `box2d_mt_tpu.parallel.sharding`. The JAX package batches worlds
into one program and shards the world axis over a device mesh, with
`jit` partitioning the step. Here a step is eager PyTorch on the host's
clock (thousands of kernel launches and a few host reads of predicates
a step), so a shard needs a host thread of its own: `make_sharded_step`
cuts the batch into contiguous shards, one per entry of `devices`, and
steps each from its own persistent thread on its own CUDA stream. A
device may repeat (several shards on one card) and CPU devices shard too.

Worlds never exchange anything: every branch the step takes on a
predicate over the whole batch leaves the worlds it does not concern as
they were (`world.step_batched`), so a shard decides its predicates over
its own worlds, the threads share no barrier, and every world comes out
bit for bit as in the unsharded step of the whole batch. The threads of
one process share one GIL, so they take turns on the host
(`ops/sync.py`): only a shard's waits on its device overlap the others'
work.
"""

import concurrent.futures
import threading
from typing import NamedTuple, Tuple

import torch

from ..ops.sync import taking_turns
from ..state import State, concat_worlds, map_leaves
from ..state import replicate as replicate_state  # noqa: F401 (the JAX name)
from ..world import Events, possible_kinds, step_batched

def batch_states(states) -> State:
    """Stack one-world States (frozen with the same capacities) into one
    batch, in order: the JAX package's stack of unbatched States (a port
    State always has a world axis; `state.concat_worlds` joins batches of
    any size)."""
    states = list(states)
    sizes = [st.n_worlds for st in states]
    if not states or any(n != 1 for n in sizes):
        raise ValueError(f"batch_states takes one-world States, got worlds {sizes}")
    return concat_worlds(states)


def make_batched_step(**step_kwargs):
    """step(states, dt) -> (states, events): `step_batched` with these
    keywords. The contact kinds, unless given, are `possible_kinds` of the
    first batch the step sees (read once)."""
    kw = dict(step_kwargs)

    def _step(states, dt):
        if kw.get("kinds") is None:
            kw["kinds"] = possible_kinds(states)
        return step_batched(states, dt, **kw)

    return _step


def make_rollout(n_steps: int, **step_kwargs):
    """Returns rollout(states, dt) -> states after n_steps batched steps.
    The JAX rollout is one `lax.scan` program; here it is a Python loop of
    eager steps. The contact kinds default to the batch's possible kinds."""
    fixed_kinds = step_kwargs.pop("kinds", None)

    def rollout(states, dt):
        kinds = fixed_kinds or possible_kinds(states)
        for _ in range(n_steps):
            states, _ = step_batched(states, dt, kinds=kinds, **step_kwargs)
        return states

    return rollout


def _synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ShardedState(NamedTuple):
    """A batch cut along the world axis: `shards[i]` (a State) lives on
    `devices[i]`; `kinds` are the contact kinds of the whole batch."""
    shards: Tuple[State, ...]
    devices: Tuple[torch.device, ...]
    kinds: tuple

    def gather(self) -> State:
        """One batched State of every world in order, on the first shard's
        device."""
        device = self.devices[0]
        out = concat_worlds([map_leaves(lambda t: t.to(device), st)
                             for st in self.shards])
        _synchronize(device)
        return out


class ShardedEvents(NamedTuple):
    """The Events of one sharded step, a shard's each."""
    shards: Tuple[Events, ...]

    def gather(self) -> Events:
        """One Events of every world in order, on the first shard's device;
        `host_syncs` is the sum over the shards."""
        device = self.shards[0].f_a.device
        fields = {name: torch.cat([getattr(ev, name).to(device) for ev in self.shards])
                  for name in Events._fields if name != "host_syncs"}
        _synchronize(device)
        return Events(**fields, host_syncs=sum(ev.host_syncs for ev in self.shards))


# The shard threads of a process take turns on the host (ops/sync.py): a
# thread steps its shard holding the turn and hands it on at each host
# read, while it waits for its device. Without turns, threads stepping
# side by side pass the GIL back and forth at every operation: 2 shards
# of 512 x pyramid(10) on one H100 stepped at a quarter of 1 shard's rate,
# 8 CPU shards of pyramid(5) 23 times slower than one (7 with turns).
_HOST_TURN = threading.Lock()


class _Shard:
    """One persistent host thread for one shard, with the shard's device
    current and, on a card, a CUDA stream of its own (PyTorch keeps the
    current device and stream per thread)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self._pool = concurrent.futures.ThreadPoolExecutor(
            1, thread_name_prefix=f"shard-{device}", initializer=self._enter)

    def _enter(self):
        if self.stream is not None:
            torch.cuda.set_device(self.device)
            torch.cuda.set_stream(self.stream)

    def submit(self, fn, *args, **kwargs):
        """Run fn(*args, **kwargs) on this shard's thread, with the caller's
        grad and inference modes and CPU thread count (each is the
        thread's own in PyTorch); the work it queued on the card is
        finished when the future is."""
        grad, inference = torch.is_grad_enabled(), torch.is_inference_mode_enabled()
        n_threads = torch.get_num_threads()

        def job():
            if torch.get_num_threads() != n_threads:
                torch.set_num_threads(n_threads)
            with taking_turns(_HOST_TURN), torch.inference_mode(inference), \
                    torch.set_grad_enabled(grad):
                out = fn(*args, **kwargs)
            if self.stream is not None:
                self.stream.synchronize()
            return out

        return self._pool.submit(job)

    def close(self):
        self._pool.shutdown(wait=True)


def _results(futures):
    """Every shard's result once all are done; a shard's exception is
    re-raised here, in the caller's thread."""
    concurrent.futures.wait(futures)
    return [f.result() for f in futures]


def make_sharded_step(devices=None, **step_kwargs):
    """Shard the world axis of a batched State over `devices` and step each
    shard from its own host thread.

    `devices` is a sequence of `torch.device`s, every visible card by
    default (there is no CPU default: with no card, pass CPU devices). A
    device may repeat. Returns (step, shard_state):

      shard_state(states) -> ShardedState: the W worlds cut into
          len(devices) contiguous shards of W / len(devices) worlds, each
          copied onto its device by its own thread; the contact kinds
          (`kinds=` or `possible_kinds` of the whole batch) are shared by
          every shard, as the JAX package's sharded step compiles one
          program for all;
      step(sharded, dt) -> (ShardedState, ShardedEvents): `step_batched`
          of every shard with `dt` and these keywords, the shards side by
          side; the threads sync their own streams before returning.

    Both containers have `gather()`: one batched State, one Events (with
    the shards' host syncs summed) in world order. `step.close()` stops
    the threads."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_sharded_step: no CUDA device is visible; pass "
                               "`devices` (CPU devices shard too)")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = tuple(_indexed(torch.device(d)) for d in devices)
    if not devices:
        raise ValueError("make_sharded_step: no devices")
    fixed_kinds = step_kwargs.pop("kinds", None)
    shards = [_Shard(d) for d in devices]

    def shard_state(states: State) -> ShardedState:
        n, k = states.n_worlds, len(devices)
        if n % k:
            raise ValueError(f"make_sharded_step: {n} worlds do not split evenly over "
                             f"{k} devices")
        kinds = tuple(fixed_kinds or possible_kinds(states))
        _synchronize(states.gravity.device)
        per = n // k

        def part(i, device):
            # a fresh copy, made on the shard thread's own stream
            return map_leaves(lambda t: t[i * per:(i + 1) * per].to(device, copy=True),
                              states)

        parts = _results([s.submit(part, i, s.device) for i, s in enumerate(shards)])
        return ShardedState(tuple(parts), devices, kinds)

    def step(sharded: ShardedState, dt):
        if tuple(sharded.devices) != devices:
            raise ValueError(f"step: the state is sharded over {sharded.devices}, this "
                             f"step over {devices}")
        out = _results([s.submit(step_batched, st, dt, kinds=sharded.kinds,
                                 **step_kwargs)
                        for s, st in zip(shards, sharded.shards)])
        return (ShardedState(tuple(st for st, _ in out), devices, sharded.kinds),
                ShardedEvents(tuple(ev for _, ev in out)))

    def close():
        for s in shards:
            s.close()

    step.close = close
    return step, shard_state


def _indexed(device: torch.device) -> torch.device:
    """`cuda` names the current card: give it its index."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device
