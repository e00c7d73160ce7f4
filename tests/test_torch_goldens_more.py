"""The port against the JAX package and Box2D's C++ goldens on the scenes
no other port test holds: the TOI mini island of edge_shapes, seven
joint-free goldens as one padded batch, and add_pair held to the JAX
package's roll (its C++ golden is out of reach of both packages).

* edge_shapes(8), stepped once from the JAX package's state after 80
  steps, with `toi_neighbors=True`: the thin triangle (body 2) meets
  three terrain edges in one TOI sub-step, and the mini island applies
  their contacts one rank after another. c, a to 2e-5, v, w to 1e-4,
  awake, touching, the TOI events and the pair table equal.
* character_collision, compound_shapes(4), confined(4, 3),
  heavy_on_light_two, poly_shapes(8), pyramid(5) and edge_shapes(8)
  against their C++ traces (tests/golden/, bodies in reverse creation
  order, 8/3 iterations), rolled as one batch of worlds frozen with one
  set of capacities, each for the steps its bounds read, at the JAX
  package's bounds (tests/test_golden_zoo.py:143-189, :222-227,
  :262-268, tests/test_step.py:72-76) with the JAX tests' error measure
  (the worst |x|, |y| or angle error over the trace's bodies) and no
  color overflow in the window.
* add_pair(50, 7): the port and the JAX package rolled side by side with
  the same capacities, equal at the whole-step tolerance through step 15,
  the last step before the bullet's impact.

The joint goldens (collision_filtering, dominos, pinball, tumbler) are in
tests/test_torch_goldens_joints.py; theo_jansen's bound reads all 240
steps of a 55-body joint world, which costs more than the tier's time
allows, so it is held on the card only (chip_smoke.py phase 18).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from box2d_mt_tpu import world as jworld
from box2d_mt_tpu.models import scenes as jscenes
from box2d_mt_tpu_torch import world as tworld
from box2d_mt_tpu_torch.models import scenes as tscenes
from box2d_mt_tpu_torch.state import concat_worlds, map_leaves, state_from_numpy, to_numpy

from conftest import GOLDEN
from test_torch_toi import _close, _equal_discrete

DT = 1.0 / 60.0
# scene: (arguments, golden file, bodies in the trace, steps the bounds
# read, bound on the worst error over those steps, on steps 0-59 or None,
# on the last step or None)
GOLDENS = {
    "character_collision": ((), "character_collision_240", 11, 240, 0.1, None, None),
    "compound_shapes": ((4,), "compound_shapes_240", 13, 60, 0.2, None, None),
    "confined": ((4, 3), "confined_240", 13, 240, 0.01, None, None),
    "heavy_on_light_two": ((), "heavy_on_light_two_240", 4, 240, 0.15, None, 0.08),
    "poly_shapes": ((8,), "poly_shapes_240", 9, 240, 1.5, 0.3, None),
    "pyramid": ((5,), "pyramid_5_240", 16, 240, 0.05, None, 0.02),
    "edge_shapes": ((8,), "edge_shapes_240", 9, 120, 0.1, None, None),
}
# the largest capacities among them (edge_shapes' terrain sets the
# fixtures and contacts)
CAPACITY = dict(body_capacity=16, fixture_capacity=128, contact_capacity=512)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """These tensors are a few worlds wide: PyTorch's intra-op threads cost
    more than they give, and workers running side by side share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def windowed_roll(st, window, **step_kw):
    """Step the padded batch `st` in inference mode for max(window) steps,
    world w leaving the batch once its window[w] steps are done. Yields
    (step, alive, state, events) after each step; `alive` lists the
    batch's worlds by their index in `window`."""
    kinds = tworld.possible_kinds(st)
    alive = list(range(len(window)))
    with torch.inference_mode():
        for i in range(max(window)):
            if any(window[w] <= i for w in alive):
                rows = [r for r, w in enumerate(alive) if window[w] > i]
                alive = [alive[r] for r in rows]
                idx = torch.tensor(rows)
                st = map_leaves(lambda t: t.index_select(0, idx), st)
            st, ev = tworld.step_batched(st, DT, kinds=kinds, **step_kw)
            yield i, alive, st, ev


def roll_goldens(specs, capacity, **step_kw):
    """Roll the scenes of `specs` ({name: (arguments, golden, bodies,
    steps, ...)}) as one padded batch, each world leaving the batch when
    its window ends. Returns {name: (errors per step, color overflow per
    step)} with the JAX tests' error measure."""
    st = concat_worlds([getattr(tscenes, name)(*spec[0], device="cpu", **capacity)
                        for name, spec in specs.items()])
    names = list(specs)
    refs = [[json.loads(line) for line in open(GOLDEN / f"{spec[1]}.jsonl")]
            for spec in specs.values()]
    errs = {name: [] for name in names}
    overflow = {name: [] for name in names}
    for i, alive, st, ev in windowed_roll(st, [spec[3] for spec in specs.values()],
                                          velocity_iterations=8, position_iterations=3,
                                          **step_kw):
        p, a = st.bodies.xf_p.numpy(), st.bodies.a.numpy()
        ovf = ev.color_overflow.numpy()
        for r, w in enumerate(alive):
            name = names[w]
            n_bodies = specs[name][2]
            e = 0.0
            for j, rb in enumerate(refs[w][i]["bodies"]):
                k = n_bodies - 1 - j
                e = max(e, abs(p[r, k, 0] - rb[0]), abs(p[r, k, 1] - rb[1]),
                        abs(a[r, k] - rb[2]))
            errs[name].append(e)
            overflow[name].append(int(ovf[r]))
    return {name: (np.asarray(errs[name]), np.asarray(overflow[name])) for name in names}


@pytest.fixture(scope="module")
def golden_errors():
    return roll_goldens(GOLDENS, CAPACITY)


@pytest.mark.parametrize("scene", list(GOLDENS))
def test_port_meets_golden(golden_errors, scene):
    """The scene's window against its C++ trace at the JAX package's
    bounds, with no color overflow."""
    _, _, _, steps, worst, first60, last = GOLDENS[scene]
    e, overflow = golden_errors[scene]
    print(f"{scene}: steps 0-{steps - 1} worst {e.max():.4g}, 0-59 {e[:60].max():.4g}, "
          f"last {e[-1]:.4g}")
    assert len(e) == steps
    assert overflow.sum() == 0
    assert e.max() < worst, e.max()
    assert first60 is None or e[:60].max() < first60, e[:60].max()
    assert last is None or e[-1] < last, e[-1]


def test_edge_shapes_toi_step_matches_jax():
    """Step 81 of edge_shapes(8) from the JAX package's state: the mini
    island's neighbor constraints are prepared at their parent lane's
    solved pose, as the JAX package prepares them."""
    kw = dict(velocity_iterations=8, position_iterations=3)
    jst = jscenes.edge_shapes(8)
    kinds = jworld.possible_kinds(jst)
    for _ in range(80):
        jst, _ = jworld.step(jst, jnp.float32(DT), kinds=kinds, toi_neighbors=True, **kw)
    tst = state_from_numpy(jax.tree.map(np.asarray, jst), device="cpu")
    jst, jev = jworld.step(jst, jnp.float32(DT), kinds=kinds, toi_neighbors=True, **kw)
    tst, tev = tworld.step(tst, DT, kinds=kinds, toi_neighbors=True, **kw)
    j, t = jax.tree.map(np.asarray, jst), to_numpy(tst)
    assert int(np.asarray(jev.toi_begin).sum()) > 0           # a TOI sub-step touched
    _close(t, j, 80)
    _equal_discrete(t, tev, j, jax.tree.map(np.asarray, jev), 80)
    for k in ("f_a", "f_b"):
        np.testing.assert_array_equal(getattr(t.contacts, k)[0], getattr(j.contacts, k))


def test_add_pair_matches_jax_before_impact():
    """add_pair(50, 7), rolled in both packages with the same capacities:
    equal at the whole-step tolerance, with awake and the pair table
    equal, through step 15; the bullet's impact (ten TOI touches) comes
    at step 16."""
    jst = jscenes.add_pair(50, 7)
    tst = tscenes.add_pair(50, 7, device="cpu")
    assert tst.contacts.capacity == jst.contacts.f_a.shape[0]
    kinds = jworld.possible_kinds(jst)
    for i in range(17):
        jst, jev = jworld.step(jst, jnp.float32(DT), kinds=kinds)
        tst, tev = tworld.step(tst, DT, kinds=kinds)
        if i == 16:
            assert int(np.asarray(jev.toi_begin).sum()) > 0
            break
        j, t = jax.tree.map(np.asarray, jst), to_numpy(tst)
        _close(t, j, i)
        np.testing.assert_array_equal(t.bodies.awake[0], j.bodies.awake, err_msg=f"@{i}")
        np.testing.assert_array_equal(t.contacts.f_a[0], j.contacts.f_a, err_msg=f"@{i}")
        np.testing.assert_array_equal(t.contacts.f_b[0], j.contacts.f_b, err_msg=f"@{i}")
        assert int(np.asarray(jev.toi_begin).sum()) == 0
