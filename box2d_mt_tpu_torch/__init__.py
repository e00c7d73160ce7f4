"""box2d_mt_tpu_torch — the PyTorch / CUDA port of box2d_mt_tpu.

A batched 2D rigid-body engine on tensors with a leading world axis. This
slice runs the contact-only step (`continuous=False`) of polygon/edge
worlds such as `models.scenes.pyramid`; its solve middle is a CUDA kernel
for Hopper (csrc/solve_middle.cu) with a plain PyTorch version for CPU
tensors. Quick start::

    from box2d_mt_tpu_torch import step_batched
    from box2d_mt_tpu_torch.models import scenes
    from box2d_mt_tpu_torch.state import replicate

    states = replicate(scenes.pyramid(10, device="cuda"), 512)
    for _ in range(60):
        states, events = step_batched(states, 1 / 60, continuous=False)
"""

from . import math2d, settings, shapes, state
from .state import Bodies, Contacts, Fixtures, State, replicate, state_from_numpy, to_numpy
from .world import Events, WorldBuilder, possible_kinds, step, step_batched

__all__ = [
    "WorldBuilder", "Events", "step", "step_batched", "possible_kinds",
    "State", "Bodies", "Fixtures", "Contacts", "state_from_numpy", "to_numpy",
    "replicate", "math2d", "settings", "shapes", "state",
]
