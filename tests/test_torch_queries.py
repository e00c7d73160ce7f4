"""The port's ray casts, AABB queries and shape cast against the JAX package.

  * `ray_cast_all`, `ray_cast_closest` and `query_aabb` (fat and tight) on
    a world of circles, boxes, a rotated polygon and edges, for 64 rays
    from a numpy seed: hit masks equal, fractions within 1e-5 of the JAX
    package's, and what derives from the fraction within that 1e-5 carried
    through: hit points (p1 + fraction (p2 - p1)) within 1e-5 times the
    ray's length, normals within 1e-5 and a circle's (the unit vector from
    its center to the hit point) within 1e-5 times the ray's length over
    the radius. A circle's fraction solves a quadratic whose discriminant
    cancels on grazing rays, where the two packages' roundings differ by
    ~1e-6; batched, two worlds with a ray each, equal to the one-world
    calls;
  * `shape_cast` against the C++ fixtures of tests/golden/shapecast.jsonl
    at the JAX test's rules (tests/test_distance.py:48-81), and against
    the JAX package's vmapped shape_cast lane by lane: hits and iteration
    counts equal, lambda within 1e-5, and where a lane hits, the point
    within 1e-5 and the normal within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from box2d_mt_tpu import math2d as jmath
from box2d_mt_tpu import settings as jsettings
from box2d_mt_tpu import shapes as jshapes
from box2d_mt_tpu import world as jworld
from box2d_mt_tpu.ops import distance as jdst
from box2d_mt_tpu.ops import raycast as jray
from box2d_mt_tpu_torch import math2d, query_aabb, ray_cast_all, ray_cast_closest
from box2d_mt_tpu_torch import settings, shapes, shape_cast, world
from box2d_mt_tpu_torch.state import concat_worlds

from conftest import load_jsonl


def _scene(pkg_world, pkg_shapes, pkg_settings, **kw):
    wb = pkg_world.WorldBuilder(gravity=(0.0, 0.0))
    b0 = wb.create_body(position=(5.0, 0.0))
    wb.create_fixture(b0, pkg_shapes.Circle(1.0))
    b1 = wb.create_body(position=(10.0, 0.0), angle=0.4)
    wb.create_fixture(b1, pkg_shapes.Polygon.box(1.0, 0.5))
    b2 = wb.create_body()
    wb.create_fixture(b2, pkg_shapes.Edge((14.0, -2.0), (14.0, 2.0)))
    wb.create_fixture(b2, pkg_shapes.Edge((-4.0, -3.0), (20.0, -3.0)))
    b3 = wb.create_body(body_type=pkg_settings.DYNAMIC_BODY, position=(7.0, 3.0), angle=1.1)
    wb.create_fixture(b3, pkg_shapes.Polygon.from_vertices(
        [(-1.0, 0.0), (1.0, -0.5), (1.5, 0.5), (0.0, 1.2), (-0.8, 0.9)]), density=1.0)
    wb.create_fixture(b3, pkg_shapes.Circle(0.4, (0.3, -1.0)), density=1.0)
    b4 = wb.create_body(position=(2.0, 2.0), enabled=False)
    wb.create_fixture(b4, pkg_shapes.Polygon.box(0.5, 0.5))
    return wb.freeze(**kw)


@pytest.fixture(scope="module")
def worlds():
    return _scene(jworld, jshapes, jsettings), _scene(world, shapes, settings, device="cpu")


def _rays(n=64, seed=0):
    rng = np.random.default_rng(seed)
    p1 = rng.uniform([-6.0, -5.0], [2.0, 6.0], (n, 2)).astype(np.float32)
    p2 = rng.uniform([8.0, -5.0], [22.0, 6.0], (n, 2)).astype(np.float32)
    frac = rng.uniform(0.3, 1.0, n).astype(np.float32)
    return p1, p2, frac


def test_ray_casts_match_jax(worlds):
    jst, tst = worlds
    j_all, j_closest = jax.jit(jray.ray_cast_all), jax.jit(jray.ray_cast_closest)
    hits = 0
    for p1, p2, f in zip(*_rays()):
        j = j_all(jst, p1, p2, f)
        t = ray_cast_all(tst, p1, p2, float(f))
        jhit = np.asarray(j.hit)
        assert np.array_equal(t.hit[0].numpy(), jhit)
        hits += int(jhit.sum())
        np.testing.assert_allclose(t.fraction[0].numpy()[jhit], np.asarray(j.fraction)[jhit],
                                   atol=1e-5, rtol=0)
        reach = 1e-5 * float(np.linalg.norm(p2 - p1))
        np.testing.assert_allclose(t.point[0].numpy()[jhit], np.asarray(j.point)[jhit],
                                   atol=reach, rtol=0)
        circle = tst.fixtures.shape_type[0].numpy() == settings.SHAPE_CIRCLE
        r = tst.fixtures.radius[0].numpy()
        radius = np.where(circle & (r > 0), r, 1.0)     # empty slots: radius 0
        n_tol = np.where(circle, reach / radius, 1e-5)[jhit]
        n_err = np.abs(t.normal[0].numpy()[jhit] - np.asarray(j.normal)[jhit]).max(-1)
        assert (n_err <= n_tol).all(), (n_err, n_tol)
        jc = j_closest(jst, p1, p2, f)
        tc = ray_cast_closest(tst, p1, p2, float(f))
        assert bool(tc[0][0]) == bool(jc[0]) and int(tc[1][0]) == int(jc[1])
        if bool(jc[0]):
            k_tol = n_tol[np.flatnonzero(jhit).tolist().index(int(jc[1]))]
            for k, tol in ((2, reach), (3, k_tol), (4, 1e-5)):
                np.testing.assert_allclose(tc[k][0].numpy(), np.asarray(jc[k]), atol=tol,
                                           rtol=0)
    assert hits > 64        # every shape kind is crossed by some ray


def test_query_aabb_matches_jax(worlds):
    jst, tst = worlds
    rng = np.random.default_rng(1)
    for _ in range(32):
        lo = rng.uniform([-5.0, -5.0], [18.0, 5.0]).astype(np.float32)
        hi = lo + rng.uniform(0.1, 6.0, 2).astype(np.float32)
        for fat in (True, False):
            got = query_aabb(tst, lo, hi, use_fat=fat)[0].numpy()
            assert np.array_equal(got, np.asarray(jray.query_aabb(jst, lo, hi, use_fat=fat)))


def test_queries_batched(worlds):
    """Two worlds, a ray and a box each: each world's answer equals the
    one-world call's."""
    _, tst = worlds
    pair = concat_worlds([tst, tst])
    p1 = torch.tensor([[0.0, 0.0], [0.0, 3.0]])
    p2 = torch.tensor([[20.0, 0.0], [20.0, 3.5]])
    both = ray_cast_all(pair, p1, p2)
    closest = ray_cast_closest(pair, p1, p2)
    for w in (0, 1):
        one = ray_cast_all(tst, p1[w], p2[w])
        for a, b in zip(both, one):
            assert torch.equal(a[w], b[0])
        one_c = ray_cast_closest(tst, p1[w], p2[w])
        for a, b in zip(closest, one_c):
            assert torch.equal(a[w], b[0])
    assert int(closest[1][0]) == 0 and int(closest[1][1]) != int(closest[1][0])
    boxes = query_aabb(pair, torch.tensor([[4.0, -1.0], [6.0, 2.0]]),
                       torch.tensor([[6.0, 1.0], [8.0, 4.0]]))
    assert torch.equal(boxes[0], query_aabb(tst, (4.0, -1.0), (6.0, 1.0))[0])
    assert torch.equal(boxes[1], query_aabb(tst, (6.0, 2.0), (8.0, 4.0))[0])


def _proxy(d):
    v = np.zeros((8, 2), np.float32)
    vs = np.asarray(d["verts"], np.float32)
    v[:len(vs)] = vs
    return v, len(vs), np.float32(d["radius"])


@pytest.fixture(scope="module")
def shapecast_lanes():
    rows = load_jsonl("shapecast.jsonl")
    a = [_proxy(r["a"]) for r in rows]
    b = [_proxy(r["b"]) for r in rows]
    xfa = np.asarray([r["xfa"] for r in rows], np.float32)
    xfb = np.asarray([r["xfb"] for r in rows], np.float32)
    lanes = dict(va=np.stack([x[0] for x in a]), ca=np.asarray([x[1] for x in a], np.int32),
                 ra=np.asarray([x[2] for x in a], np.float32),
                 vb=np.stack([x[0] for x in b]), cb=np.asarray([x[1] for x in b], np.int32),
                 rb=np.asarray([x[2] for x in b], np.float32),
                 pa=xfa[:, 0:2], aa=xfa[:, 2], pb=xfb[:, 0:2], ab=xfb[:, 2],
                 tr=np.asarray([r["tr"] for r in rows], np.float32))
    return rows, lanes


def _port_cast(lanes):
    t = {k: torch.from_numpy(v) for k, v in lanes.items()}
    return shape_cast(t["va"], t["ca"], t["ra"], t["pa"], math2d.rot_from_angle(t["aa"]),
                      t["vb"], t["cb"], t["rb"], t["pb"], math2d.rot_from_angle(t["ab"]),
                      t["tr"])


def test_shape_cast_matches_reference(shapecast_lanes):
    """The JAX test's rules: hit flags, lambda where both hit, and the cast
    normal where both hit at a positive distance."""
    rows, lanes = shapecast_lanes
    hit, _, normal, lam, _ = (x.numpy() for x in _port_cast(lanes))
    ref_hit = np.asarray([r["hit"] for r in rows]) > 0
    ref_lam = np.asarray([r["lambda"] for r in rows])
    ref_n = np.asarray([r["normal"] for r in rows])
    both = hit & ref_hit & (ref_lam > 0)
    assert (hit != ref_hit).sum() <= max(2, len(rows) // 50)
    assert (hit & ref_hit & (np.abs(lam - ref_lam) > 5e-3)).sum() <= max(2, int(both.sum()) // 50)
    assert (both & (np.abs(normal - ref_n).max(axis=1) > 1e-2)).sum() <= max(
        2, int(both.sum()) // 50)
    assert hit.sum() > 0 and (~hit).sum() > 0


def test_shape_cast_matches_jax(shapecast_lanes):
    _, lanes = shapecast_lanes
    j = {k: jnp.asarray(v) for k, v in lanes.items()}
    ref = jax.jit(jax.vmap(jdst.shape_cast))(
        j["va"], j["ca"], j["ra"], j["pa"], jmath.rot_from_angle(j["aa"]),
        j["vb"], j["cb"], j["rb"], j["pb"], jmath.rot_from_angle(j["ab"]), j["tr"])
    got = _port_cast(lanes)
    hit, ref_hit = got[0].numpy(), np.asarray(ref[0])
    assert np.array_equal(hit, ref_hit)
    assert np.array_equal(got[4].numpy(), np.asarray(ref[4]))
    np.testing.assert_allclose(got[3].numpy(), np.asarray(ref[3]), atol=1e-5, rtol=0)
    # a lane that fails (a miss or an overlap) has no cast point or normal:
    # its v shrank to rounding noise, whose direction means nothing. A hit's
    # normal is v / |v| with |v| near the radii's sum (0.02 for polygons),
    # so the rounding of world coordinates of size ~5 grows 50-fold in it
    np.testing.assert_allclose(got[1].numpy()[hit], np.asarray(ref[1])[hit], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[2].numpy()[hit], np.asarray(ref[2])[hit], atol=1e-4, rtol=0)
