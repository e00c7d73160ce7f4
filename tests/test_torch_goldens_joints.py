"""The port against Box2D's C++ goldens of four joint scenes (generated by
tools/golden_gen/golden7.cpp and golden8.cpp; bodies in reverse creation
order, stepped at 8/3 iterations), rolled as one padded batch of worlds
for 240 steps at the JAX package's bounds (tests/test_golden_zoo.py:
192-207, :229-235, :247-251):

  * collision_filtering: worst < 0.2 and last step < 0.05;
  * dominos: worst < 0.4;
  * pinball: worst < 0.05;
  * tumbler(40): steps 0-59 < 0.05.

The JAX test steps the tumbler at max_colors=48, which both packages
refuse (32 at most), so the batch runs at 32 colors: the bound's window
is free of color overflow, and later in the roll the jammed pile needs
the overflow color, which the port then runs (its Jacobi chunks). The
test says so: overflow is zero in steps 0-59 and nonzero over the roll.
The other three scenes never overflow. Their errors are the same at 32
colors as at the default 24: a budget no world reaches changes no color.
"""

import numpy as np
import pytest
import torch

from test_torch_goldens_more import roll_goldens

# scene: (arguments, golden file, bodies in the trace, steps rolled,
# bound on the worst error over them or None, on steps 0-59 or None, on
# the last step or None)
GOLDENS = {
    "collision_filtering": ((), "collision_filtering_240", 8, 240, 0.2, None, 0.05),
    "dominos": ((), "dominos_240", 23, 240, 0.4, None, None),
    "pinball": ((), "pinball_240", 4, 240, 0.05, None, None),
    "tumbler": ((40,), "tumbler_240", 42, 240, None, 0.05, None),
}
CAPACITY = dict(body_capacity=64, fixture_capacity=64, contact_capacity=256,
                joint_capacity={"revolute": 4, "distance": 1, "prismatic": 1})


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """These tensors are a few worlds wide: PyTorch's intra-op threads cost
    more than they give, and workers running side by side share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def golden_errors():
    return roll_goldens(GOLDENS, CAPACITY, max_colors=32)


@pytest.mark.parametrize("scene", list(GOLDENS))
def test_port_meets_joint_golden(golden_errors, scene):
    _, _, _, steps, worst, first60, last = GOLDENS[scene]
    e, overflow = golden_errors[scene]
    print(f"{scene}: worst {e.max():.4g}, steps 0-59 {e[:60].max():.4g}, last {e[-1]:.4g}, "
          f"color overflow {overflow.sum()} lane-steps")
    assert len(e) == steps and np.isfinite(e).all()
    assert worst is None or e.max() < worst, e.max()
    assert first60 is None or e[:60].max() < first60, e[:60].max()
    assert last is None or e[-1] < last, e[-1]
    assert overflow[:60].sum() == 0
    if scene == "tumbler":
        assert overflow.sum() > 0          # the overflow color runs later in the roll
    else:
        assert overflow.sum() == 0
