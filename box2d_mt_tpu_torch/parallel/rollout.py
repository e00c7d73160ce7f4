"""Multi-world batching: replicate a world and roll a batch forward.

Counterparts of `box2d_mt_tpu.parallel.sharding.replicate_state` and
`make_rollout`. The JAX rollout is one `lax.scan` program; here it is a
Python loop of eager steps (a CUDA-graph capture is later work)."""

from ..state import replicate as replicate_state  # noqa: F401 (the JAX name)
from ..world import possible_kinds, step_batched


def make_rollout(n_steps: int, **step_kwargs):
    """Returns rollout(states, dt) -> states after n_steps batched steps.
    The contact kinds default to the batch's possible kinds."""
    fixed_kinds = step_kwargs.pop("kinds", None)

    def rollout(states, dt):
        kinds = fixed_kinds or possible_kinds(states)
        for _ in range(n_steps):
            states, _ = step_batched(states, dt, kinds=kinds, **step_kwargs)
        return states

    return rollout
