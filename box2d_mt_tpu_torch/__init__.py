"""box2d_mt_tpu_torch — the PyTorch / CUDA port of box2d_mt_tpu.

A batched 2D rigid-body engine on tensors with a leading world axis. It
runs the step of worlds of circles, edges, polygons and chains such as
`models.scenes.pyramid`, continuous collision included, and of worlds
with joints of all eleven of Box2D's types such as `models.scenes.tumbler`
and `models.scenes.car`, with the PreSolve and contact-filter hooks, the
batched between-step mutations (`mutate`), ray and shape casts, the PBD
rope (`rope`), checkpoints and counts (`diagnostics`), `draw`, and the
step's spans and counters (`trace`); its solve middle (one kernel, or
four around the joint passes), its time of impact and its constraint
coloring are CUDA kernels for Hopper (csrc/solve_middle.cu, csrc/toi.cu,
csrc/coloring.cu), each with a plain PyTorch version for CPU tensors.
States are built on the card unless the caller passes another `device`.
Quick start::

    from box2d_mt_tpu_torch import step_batched
    from box2d_mt_tpu_torch.models import scenes
    from box2d_mt_tpu_torch.state import replicate

    states = replicate(scenes.pyramid(10), 512)
    for _ in range(60):
        states, events = step_batched(states, 1 / 60)
"""

from . import math2d, settings, shapes, state
from .state import (Bodies, Contacts, Fixtures, Joints, State, replicate,
                    state_from_numpy, to_numpy)
from .world import Events, PreSolveView, WorldBuilder, possible_kinds, step, step_batched
from . import diagnostics, draw, mutate, rope, trace
from .ops.raycast import query_aabb, ray_cast_all, ray_cast_closest
from .ops.distance import shape_cast

__all__ = [
    "WorldBuilder", "Events", "PreSolveView", "step", "step_batched",
    "possible_kinds", "State", "Bodies", "Fixtures", "Contacts", "Joints",
    "state_from_numpy", "to_numpy", "replicate", "math2d", "settings", "shapes",
    "state", "mutate", "rope", "diagnostics", "draw", "ray_cast_closest",
    "ray_cast_all", "query_aabb", "shape_cast", "trace",
]
