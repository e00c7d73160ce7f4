"""The port's builder and state bridge against the JAX package: scenes
built by either package are equal field by field, bit for bit (initial
fat AABBs and pair table included), and the numpy round trip is exact."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from box2d_mt_tpu.models import scenes as jscenes
from box2d_mt_tpu_torch.models import scenes as tscenes
from box2d_mt_tpu_torch.state import (replicate, state_from_numpy, to_numpy,
                                      map_leaves)

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
