"""The port's continuous collision against the C++ goldens of three CCD
scenes (generated by tools/golden_gen/golden6.cpp; bodies listed in
reverse creation order, stepped at 8/3 iterations):

  * bullet_test (Testbed BulletTest.h): a dense bullet dropped at -50 m/s
    onto a thin plank; the first TOI impact and the mini island's response
    on the plank's obstacle hit, steps 0-8, below 2e-2;
  * continuous_test (ContinuousTest.h): a spinning plank launched at
    -100 m/s onto an edge ground, 120 steps below 3e-2;
  * bullet_on_stack: a bullet fired into the base of a five-box stack,
    steps 0-59 below 0.1.

The bounds are the JAX package's own (tests/test_golden_zoo.py:117-139).
The three roll as one padded batch of worlds with continuous collision
on (the time-of-impact wrapper takes its plain version for CPU tensors),
for as many steps as the longest window reads. Each scene, built by the
port's WorldBuilder, also equals the JAX package's frozen state leaf by
leaf.
"""

import json

import jax
import numpy as np
import pytest
import torch

from box2d_mt_tpu.models import scenes as jscenes
from box2d_mt_tpu_torch import world as tworld
from box2d_mt_tpu_torch.models import scenes as tscenes
from box2d_mt_tpu_torch.state import concat_worlds, to_numpy

from conftest import GOLDEN
from test_torch_state import _leaves

# scene: (JAX builder, bodies in the golden, steps the bound reads, bound)
_GOLDENS = {
    "bullet_test": (jscenes.bullet_test, 3, 9, 2e-2),
    "continuous_test": (jscenes.continuous_test, 2, 120, 3e-2),
    "bullet_on_stack": (jscenes.bullet_on_stack, 7, 60, 0.1),
}
# the capacities of the largest scene: all three are frozen with them, so
# that they roll as one batch of worlds
_CAPACITY = dict(body_capacity=8, fixture_capacity=8, contact_capacity=64)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """These tensors are a few worlds wide: PyTorch's intra-op threads cost
    more than they give, and workers running side by side share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("scene", list(_GOLDENS))
def test_port_ccd_scene_equals_jax_scene(scene):
    """Bit for bit, every leaf: bodies (the bullet flag and the launch
    velocities included), fixtures, the initial pair table and the cache."""
    jn = jax.tree.map(np.asarray, _GOLDENS[scene][0]())
    tn = to_numpy(getattr(tscenes, scene)(device="cpu"))
    for name, got in _leaves(tn):
        g, _, f = name.partition(".")
        ref = np.asarray(getattr(getattr(jn, g), f) if f else getattr(jn, g))
        assert got.shape == (1,) + ref.shape, name
        assert got.dtype == ref.dtype, name
        assert np.array_equal(got[0], ref), name
    assert bool(tn.bodies.bullet.any()) == (scene != "continuous_test")


@pytest.fixture(scope="module")
def golden_worst():
    """Each scene's worst position/angle error against the C++ trace over
    the steps its bound reads, whether each of those steps was free of
    color overflow, and whether a TOI impact created a touch in it."""
    st = concat_worlds([getattr(tscenes, name)(device="cpu", **_CAPACITY)
                        for name in _GOLDENS])
    refs = [[json.loads(line) for line in open(GOLDEN / f"{name}_120.jsonl")]
            for name in _GOLDENS]
    specs = list(_GOLDENS.values())
    worst = [0.0] * len(specs)
    clean = [True] * len(specs)
    impact = [False] * len(specs)
    for i in range(max(steps for _, _, steps, _ in specs)):
        st, ev = tworld.step_batched(st, 1 / 60, velocity_iterations=8,
                                     position_iterations=3)
        p, a = st.bodies.xf_p.numpy(), st.bodies.a.numpy()
        overflow = ev.color_overflow.numpy()
        toi_begin = ev.toi_begin.any(1).numpy()
        for w, ((_, n_bodies, steps, _), ref) in enumerate(zip(specs, refs)):
            if i >= steps:
                continue
            for j, rb in enumerate(ref[i]["bodies"]):
                k = n_bodies - 1 - j
                worst[w] = max(worst[w], abs(p[w, k, 0] - rb[0]), abs(p[w, k, 1] - rb[1]),
                               abs(a[w, k] - rb[2]))
            clean[w] &= int(overflow[w]) == 0
            impact[w] |= bool(toi_begin[w])
    return {name: (worst[w], clean[w], impact[w]) for w, name in enumerate(_GOLDENS)}


@pytest.mark.parametrize("scene", list(_GOLDENS))
def test_port_meets_ccd_golden(golden_worst, scene):
    """The scene's window against the C++ trace, at the JAX package's own
    bound; a TOI impact happens inside the window."""
    worst, clean, impact = golden_worst[scene]
    print(f"{scene}: worst error {worst:.3g}")
    assert clean and impact
    assert worst < _GOLDENS[scene][3]
