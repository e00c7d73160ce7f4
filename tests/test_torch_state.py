"""The port's builder and state bridge against the JAX package: scenes
built by either package are equal field by field, bit for bit (initial
fat AABBs and pair table included), and the numpy round trip is exact.

The zoo scenes that the port steps (circles, chains, sensors, the four
ported joint types) are held the same way, joint blocks included; only
the fat AABBs of rotated bodies may differ, by at most 4 units in the
last place: they come from the body's sine and cosine, and XLA's and
PyTorch's differ in the last bit."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from box2d_mt_tpu.models import scenes as jscenes
from box2d_mt_tpu_torch.models import scenes as tscenes
from box2d_mt_tpu_torch.state import (JOINT_BLOCKS, replicate, state_from_numpy,
                                      to_numpy, map_leaves)

_GROUPS = ("bodies", "fixtures", "contacts", "cache")


def _leaves(st):
    for g in _GROUPS:
        for f in dataclasses.fields(getattr(st, g)):
            yield f"{g}.{f.name}", getattr(getattr(st, g), f.name)
    for k in ("gravity", "inv_dt0", "pairs_dirty"):
        yield k, getattr(st, k)


@pytest.mark.parametrize("scene", ["pyramid", "hello_world"])
def test_port_scene_equals_jax_scene(scene):
    if scene == "pyramid":
        jst, tst = jscenes.pyramid(6), tscenes.pyramid(6, device="cpu")
    else:
        jst, tst = jscenes.hello_world(), tscenes.hello_world(device="cpu")
    jn = jax.tree.map(np.asarray, jst)
    tn = to_numpy(tst)
    for name, got in _leaves(tn):
        g, _, f = name.partition(".")
        ref = np.asarray(getattr(getattr(jn, g), f) if f else getattr(jn, g))
        assert got.shape == (1,) + ref.shape, name
        assert got.dtype == ref.dtype, name
        assert np.array_equal(got[0], ref), name
    assert int((tn.contacts.f_a >= 0).sum()) > 0 or scene == "hello_world"


def test_state_bridge_round_trip():
    jst = jax.tree.map(np.asarray, jscenes.pyramid(6))
    st = replicate(state_from_numpy(jst, device="cpu"), 3)
    assert st.n_worlds == 3
    back = state_from_numpy(to_numpy(st), device="cpu")
    for (name, a), (_, b) in zip(_leaves(st), _leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    # copies, not views: mutating the source leaves the bridge unchanged
    host = to_numpy(st)
    bridged = state_from_numpy(host, device="cpu")
    host.bodies.c[...] = 123.0
    assert not torch.any(bridged.bodies.c == 123.0)
    assert torch.equal(map_leaves(lambda t: t, st).bodies.c, st.bodies.c)


# the zoo scenes the port steps, as the JAX package's tests build them
_ZOO = ["falling_circle", "vertical_stack", "distance_pendulum", "dominos", "web",
        "bridge", "sphere_stack", "heavy_on_light", "slider_crank", "add_pair",
        "confined", "mobile", "body_types", "varying_friction",
        "varying_restitution", "compound_shapes", "sensor_zone",
        "collision_filtering", "pinball", "theo_jansen", "heavy_on_light_two",
        "mobile_balanced", "edge_shapes", "poly_shapes", "character_collision",
        "chain_problem", "edge_test", "collision_processing", "sleep_collide_perf",
        "basic_slider_crank", "sensor_drop", "breakable", "conveyor_belt",
        "one_sided_platform", "shape_editing", "skier"]


@pytest.mark.parametrize("scene", _ZOO)
def test_zoo_scene_equals_jax_scene(scene):
    if scene == "sensor_drop":
        from test_callbacks import _sensor_scene as build   # its JAX builder
    else:
        build = getattr(jscenes, scene)
    jn = jax.tree.map(np.asarray, build())
    tn = to_numpy(getattr(tscenes, scene)(device="cpu"))
    for name, got in _leaves(tn):
        g, _, f = name.partition(".")
        ref = np.asarray(getattr(getattr(jn, g), f) if f else getattr(jn, g))
        assert got.shape == (1,) + ref.shape and got.dtype == ref.dtype, name
        if name in ("fixtures.aabb_lo", "fixtures.aabb_hi"):
            # unused slots hold +-inf on both sides
            with np.errstate(invalid="ignore"):
                near = np.abs(got[0] - ref) <= 4 * np.spacing(np.abs(ref))
            assert np.all((got[0] == ref) | near), name
        else:
            assert np.array_equal(got[0], ref), name
    for kind, _ in JOINT_BLOCKS:
        tb, jb = getattr(tn.joints, kind), getattr(jn.joints, kind)
        for f in dataclasses.fields(tb):
            assert np.array_equal(getattr(tb, f.name)[0], getattr(jb, f.name)), \
                f"{kind}.{f.name}"
