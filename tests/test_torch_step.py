"""The port's step_batched(continuous=False) against the JAX package's.

pyramid(6) x 2 worlds (32 body slots, 128 contact slots) is carried across
with `state_from_numpy` and stepped by both packages; after every step the
trajectories agree (c, a to 2e-5; v, w to 1e-4) and every discrete
quantity is equal: awake flags, the pair table, touch flags, colors and
ranks. Contacts begin near step 13 and the stack sleeps before step 90."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from box2d_mt_tpu import world as jworld
from box2d_mt_tpu.models import scenes as jscenes
from box2d_mt_tpu.parallel.sharding import replicate_state
from box2d_mt_tpu_torch import world as tworld
from box2d_mt_tpu_torch.models import scenes as tscenes
from box2d_mt_tpu_torch.parallel.sharding import make_rollout
from box2d_mt_tpu_torch.state import state_from_numpy, to_numpy

from conftest import GOLDEN

DT = 1.0 / 60.0
STEPS = 90


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """These tensors are a few worlds wide: PyTorch's intra-op threads cost
    more than they give, and workers running side by side share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trajectories():
    jst = replicate_state(jscenes.pyramid(6), 2)
    kinds = jworld.possible_kinds(jscenes.pyramid(6))
    tst = state_from_numpy(jax.tree.map(np.asarray, jst), device="cpu")
    jax_steps, port_steps, port_events = [], [], []
    for _ in range(STEPS):
        jst, jev = jworld.step_batched(jst, jnp.float32(DT), kinds=kinds,
                                       continuous=False)
        tst, tev = tworld.step_batched(tst, DT, kinds=kinds, continuous=False)
        jax_steps.append((jax.tree.map(np.asarray, jst),
                          int(np.asarray(jev.color_overflow).max())))
        port_steps.append(to_numpy(tst))
        port_events.append(tev)
    return jax_steps, port_steps, port_events


def test_step_matches_jax_every_step(trajectories):
    jax_steps, port_steps, port_events = trajectories
    touched = 0
    for i in range(40):
        (j, j_ov), t, ev = jax_steps[i], port_steps[i], port_events[i]
        jb, tb = j.bodies, t.bodies
        np.testing.assert_allclose(tb.c, jb.c, rtol=0, atol=2e-5, err_msg=f"c @{i}")
        np.testing.assert_allclose(tb.a, jb.a, rtol=0, atol=2e-5, err_msg=f"a @{i}")
        np.testing.assert_allclose(tb.v, jb.v, rtol=0, atol=1e-4, err_msg=f"v @{i}")
        np.testing.assert_allclose(tb.w, jb.w, rtol=0, atol=1e-4, err_msg=f"w @{i}")
        for grp, name in (("bodies", "awake"), ("contacts", "f_a"),
                          ("contacts", "f_b"), ("contacts", "touching"),
                          ("cache", "color"), ("cache", "rank"),
                          ("cache", "labels")):
            np.testing.assert_array_equal(
                getattr(getattr(t, grp), name), getattr(getattr(j, grp), name),
                err_msg=f"{grp}.{name} @{i}")
        assert j_ov == 0 and int(ev.color_overflow.max()) == 0
        assert ev.host_syncs >= 1
        touched = max(touched, int(t.contacts.touching.sum()))
    assert touched > 40                 # the stack is in contact by step 40


def test_sleep_matches_jax(trajectories):
    jax_steps, port_steps, port_events = trajectories
    (j, _), t = jax_steps[-1], port_steps[-1]
    np.testing.assert_array_equal(t.bodies.awake, j.bodies.awake)
    assert not (t.bodies.awake & (t.bodies.body_type == 2)).any()  # all boxes sleep
    assert port_events[-1].host_syncs == 1        # the all-asleep skip
    np.testing.assert_allclose(t.bodies.c, j.bodies.c, rtol=0, atol=2e-5)


def test_helloworld_freefall_exact():
    st = tscenes.hello_world(device="cpu")
    ref = [json.loads(line) for line in open(GOLDEN / "helloworld_60.jsonl")]
    roll = make_rollout(1, velocity_iterations=6, position_iterations=2,
                        continuous=False)
    for i in range(40):   # pure free fall, well before impact
        st = roll(st, DT)
        rb = ref[i]["bodies"][0]
        p = st.bodies.xf_p[0, 1].numpy()
        assert abs(p[1] - rb[1]) < 1e-6, f"step {i}"


def test_continuous_runs_and_unported_features_raise():
    if not torch.cuda.is_available():
        # the card is the default device: without one, torch refuses
        with pytest.raises((AssertionError, RuntimeError)):
            tscenes.pyramid(2)
    st = tscenes.pyramid(2, device="cpu")
    sts, ev = tworld.step_batched(st, DT)            # continuous=True by default
    assert ev.host_syncs >= 2 and int(ev.toi_overflow.sum()) == 0
    st, ev = tworld.step(st, DT)
    assert torch.equal(st.bodies.c, sts.bodies.c)
    st, ev = tworld.step(st, DT, continuous=False)
    assert ev.host_syncs >= 1 and not bool(ev.toi_begin.any())
    # the joint types build and step
    wb = tworld.WorldBuilder()
    wb.create_body()
    wb.create_body(body_type=2, position=(1.0, 0.0))
    wb.create_revolute_joint(0, 1, (0.0, 0.0))
    wb.create_distance_joint(0, 1, (0.0, 0.0), (1.0, 0.0))
    wb.create_prismatic_joint(0, 1, (0.0, 0.0), (1.0, 0.0))
    wb.create_weld_joint(0, 1, (0.5, 0.0))
    wb.create_joint_raw("weld", body_a=0, body_b=1)
    jst = wb.freeze(device="cpu", joint_capacity={"distance": 3})
    assert (jst.joints.revolute.active.shape[1], jst.joints.distance.active.shape[1],
            jst.joints.prismatic.active.shape[1], jst.joints.weld.active.shape[1]) == (1, 3, 1, 2)
    jst, ev = tworld.step(jst, DT)
    assert bool(torch.isfinite(jst.bodies.c).all()) and jst.joints.count == 7
    # each of the seven other types: the builder method and create_joint_raw
    # give the JAX builder's block
    for kind, args in (("mouse", (1, (0.0, 0.0))), ("friction", (0, 1, (0.0, 0.0))),
                       ("rope", (0, 1, (0.0, 0.0), (0.0, 0.0), 1.0)),
                       ("motor", (0, 1)), ("wheel", (0, 1, (0.0, 0.0), (0.0, 1.0))),
                       ("pulley", (0, 1, (0.0, 1.0), (1.0, 1.0), (0.0, 0.0), (1.0, 0.0))),
                       ("gear", (("revolute", 0), ("prismatic", 0)))):
        blocks = []
        for world, kw in ((tworld, dict(device="cpu")), (jworld, {})):
            b = world.WorldBuilder()
            b.create_body()
            b.create_body(body_type=2, position=(1.0, 0.0), angle=0.3)
            b.create_revolute_joint(0, 1, (0.0, 0.0))
            b.create_prismatic_joint(0, 1, (0.0, 0.0), (1.0, 0.0))
            getattr(b, f"create_{kind}_joint")(*args)
            b.create_joint_raw(kind, body_a=0, body_b=1)
            blocks.append(getattr(b.freeze(**kw).joints, kind))
        mine, ref = blocks
        assert mine.active.shape == (1, 2), kind
        for f in dataclasses.fields(mine):
            assert np.array_equal(getattr(mine, f.name)[0].numpy(),
                                  np.asarray(getattr(ref, f.name))), f"{kind}.{f.name}"
    with pytest.raises(ValueError, match="unknown"):
        wb.create_joint_raw("hinge", body_a=0, body_b=1)
    # the hooks are ported: a refresh consults the filter, whose answer
    # must be a bool tensor
    dirty = dataclasses.replace(st, pairs_dirty=torch.ones_like(st.pairs_dirty))
    with pytest.raises(ValueError, match="filter_fn"):
        tworld.step_batched(dirty, DT, continuous=False,
                            filter_fn=lambda s, i, j: True)
    out, _ = tworld.step_batched(dirty, DT, continuous=False,
                                 filter_fn=lambda s, i, j: i >= 0)
    assert torch.equal(out.contacts.f_a, tworld.step_batched(dirty, DT, continuous=False)[0]
                       .contacts.f_a)
