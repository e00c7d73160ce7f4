"""The port's diagnostics and draw modules against the JAX package.

  * `counts`, `dump` and `draw_data` on gear_train and a rotated-box world
    equal the JAX package's (world-space vertices within 1e-6: they pass
    through each package's sine and cosine); `draw_svg` gives the JAX
    package's SVG text;
  * `broadphase_quality` with the JAX package's hash (`spread=False`)
    equals its report on pyramid(8); with the hash the port's grid runs,
    its loads are sane and no bucket passes its 128 slots;
  * checkpoints: a save/load round trip continues bit-identically for 10
    steps, and a checkpoint the JAX package writes loads into the port
    through `load_state(path, like)`, leaf for leaf equal to the state
    bridged with `state_from_numpy`;
  * `dump_source`: the emitted Python rebuilds the world through the
    port's WorldBuilder (bit-identical at once and for 30 steps on
    basic_slider_crank; gear references remapped on gear_train; slots
    compacted after remove_body on collision_processing).
"""

import dataclasses
import io

import jax
import numpy as np
import pytest
import torch

from box2d_mt_tpu import diagnostics as jdiag
from box2d_mt_tpu import draw as jdraw
from box2d_mt_tpu import mutate as jmutate
from box2d_mt_tpu.models import scenes as jscenes
from box2d_mt_tpu_torch import diagnostics, draw, mutate, world
from box2d_mt_tpu_torch.models import scenes
from box2d_mt_tpu_torch.state import JOINT_BLOCKS, state_from_numpy


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(st):
    for g in ("bodies", "fixtures", "contacts", "cache"):
        for f in dataclasses.fields(getattr(st, g)):
            yield f"{g}.{f.name}", getattr(getattr(st, g), f.name)
    for name, _ in JOINT_BLOCKS:
        for f in dataclasses.fields(getattr(st.joints, name)):
            yield f"joints.{name}.{f.name}", getattr(getattr(st.joints, name), f.name)
    for k in ("gravity", "inv_dt0", "pairs_dirty"):
        yield k, getattr(st, k)


def _equal(a, b, groups=None):
    for (name, x), (_, y) in zip(_leaves(a), _leaves(b)):
        if groups is None or name.split(".")[0] in groups:
            assert x.dtype == y.dtype and torch.equal(x, y), name


@pytest.mark.parametrize("scene", ["gear_train", "breakable"])
def test_counts_dump_draw_match_jax(scene):
    jst = getattr(jscenes, scene)()
    tst = getattr(scenes, scene)(device="cpu")
    jc, tc = jdiag.counts(jst), diagnostics.counts(tst)
    assert list(jc) == list(tc)
    for k in jc:
        assert tc[k].shape == (1,) and int(tc[k][0]) == int(jc[k]), k
    assert diagnostics.dump(tst).splitlines()[1:] == jdiag.dump(jst).splitlines()[1:]
    jd, td = jdraw.draw_data(jst), draw.draw_data(tst)
    for name, got, ref in zip(td._fields, td, jd):
        got, ref = got[0].numpy(), np.asarray(ref)
        if name == "verts":
            live = np.asarray(jd.exists)
            np.testing.assert_allclose(got[live], ref[live], atol=1e-6, rtol=0)
        else:
            assert np.array_equal(got, ref), name
    assert draw.draw_svg(tst) == jdraw.draw_svg(jst)
    assert "polygon" in draw.draw_svg(tst)


def test_broadphase_quality():
    jst, tst = jscenes.pyramid(8), scenes.pyramid(8, device="cpu")
    ref = jdiag.broadphase_quality(jst)
    got = diagnostics.broadphase_quality(tst, spread=False)
    for k, v in ref.items():
        np.testing.assert_allclose(np.asarray(got[k]).reshape(-1)[0], v, rtol=1e-6, err_msg=k)
    mine = diagnostics.broadphase_quality(tst)
    n_fx = int(tst.fixtures.exists.sum())
    assert mine["cell_slots"] == 128 and int(mine["overfull_buckets"][0]) == 0
    assert int(mine["fixtures"][0]) == n_fx and int(mine["large_fixtures"][0]) >= 1
    assert 1 <= int(mine["max_bucket_load"][0]) <= n_fx


def test_checkpoint_roundtrip_continues_identically():
    st = scenes.pyramid(4, device="cpu")
    for _ in range(30):
        st, _ = world.step_batched(st, 1 / 60)
    buf = io.BytesIO()
    diagnostics.save_state(st, buf)
    buf.seek(0)
    back = diagnostics.load_state(buf, like=scenes.pyramid(4, device="cpu"))
    _equal(st, back)
    for _ in range(10):
        st, _ = world.step_batched(st, 1 / 60)
        back, _ = world.step_batched(back, 1 / 60)
    _equal(st, back)


def test_jax_checkpoint_loads_into_port(tmp_path):
    """The JAX package's save_state; the port's load_state with a freshly
    built port scene as `like`."""
    jst = jmutate.apply_force(jscenes.gear_train(), 2, (3.0, 1.0), (0.5, 0.5))
    jst = jmutate.set_contact_tangent_speed(jst, 0, 1, 2.0)
    path = tmp_path / "jax.npz"
    jdiag.save_state(jst, str(path))
    got = diagnostics.load_state(str(path), like=scenes.gear_train(device="cpu"))
    _equal(got, state_from_numpy(jax.tree.map(np.asarray, jst), device="cpu"))


def _replay(src):
    ns = {}
    exec(src, ns)
    return ns["state"]


def test_dump_source_fresh_world_bit_identical():
    """DumpShell.h analog on basic_slider_crank (revolute + prismatic raw
    joint defs): the replay equals the world and rolls bit-identically."""
    st_a = scenes.basic_slider_crank(device="cpu")
    src = diagnostics.dump_source(st_a)
    assert "box2d_mt_tpu_torch" in src and "box2d_mt_tpu " not in src
    st_b = _replay(src)
    _equal(st_a, st_b, groups=("bodies", "fixtures", "joints"))
    for _ in range(30):
        st_a, _ = world.step_batched(st_a, 1 / 60)
        st_b, _ = world.step_batched(st_b, 1 / 60)
    assert torch.equal(st_a.bodies.c, st_b.bodies.c)
    assert torch.equal(st_a.bodies.a, st_b.bodies.a)


def test_dump_source_gear_and_compaction():
    """gear_train's gear names its joints by block slot, remapped through
    the compaction; after two remove_body calls the replay has the live
    bodies, renumbered, at their transforms."""
    st = scenes.gear_train(device="cpu")
    _equal(st, _replay(diagnostics.dump_source(st)), groups=("joints",))
    st = scenes.collision_processing(7, device="cpu")
    st = mutate.remove_body(mutate.remove_body(st, 2), 5)
    st2 = _replay(diagnostics.dump_source(st))
    live = st.bodies.exists[0]
    assert int(st2.bodies.exists.sum()) == int(live.sum())
    assert torch.allclose(st.bodies.xf_p[0][live], st2.bodies.xf_p[0][st2.bodies.exists[0]],
                          atol=1e-5)
