"""The port's colliders against the reference golden manifolds
(tests/golden/manifolds.jsonl, 300 lanes of each of the five contact
kinds), judged as tests/test_narrowphase.py judges the JAX package; the
three circle colliders also against the JAX package's own colliders,
called un-jitted (its per-pair edge-circle collider through `jax.vmap`),
on the golden lanes and on seeded random edge-circle lanes that reach the
ghost-vertex regions: the same count, manifold type and feature ids, the
values within 2e-5."""

import numpy as np
import pytest
import torch

from box2d_mt_tpu_torch import settings
from box2d_mt_tpu_torch.ops import narrowphase as nph


def _rows(cases, key):
    n = len(cases)
    verts = np.zeros((n, 8, 2), np.float32)
    normals = np.zeros((n, 8, 2), np.float32)
    ghosts = np.zeros((n, 2), bool)
    nverts = np.zeros(n, np.int32)
    radius = np.zeros(n, np.float32)
    for i, c in enumerate(cases):
        s = c[key]
        radius[i] = s["radius"]
        if s["type"] == "circle":
            verts[i, 0] = s["center"]
            nverts[i] = 1
        elif s["type"] == "polygon":
            vs = np.asarray(s["verts"], np.float32)
            verts[i, :len(vs)] = vs
            normals[i, :len(vs)] = s["normals"]
            nverts[i] = len(vs)
        else:  # edge
            verts[i, :4] = [s["v1"], s["v2"], s["v0"], s["v3"]]
            ghosts[i] = [s["has0"], s["has3"]]
            nverts[i] = 2
    t = torch.from_numpy
    return nph.lanes_from_rows(t(verts), t(normals), t(nverts), t(ghosts),
                               t(radius))


def _xf(cases, key):
    xf = torch.tensor([c[key] for c in cases], dtype=torch.float32)
    return xf[:, 0], xf[:, 1], torch.sin(xf[:, 2]), torch.cos(xf[:, 2])


@pytest.mark.parametrize("kind", [nph.KIND_POLYGONS, nph.KIND_EDGE_POLYGON,
                                  nph.KIND_CIRCLES, nph.KIND_POLYGON_CIRCLE,
                                  nph.KIND_EDGE_CIRCLE])
def test_port_manifolds_match_reference(golden_manifolds, kind):
    cases = [c for c in golden_manifolds if c["kind"] == kind]
    assert cases
    m = nph.lanes_to_manifold(nph.CORE_COLLIDERS[kind](
        _rows(cases, "a"), *_xf(cases, "xfa"), _rows(cases, "b"),
        *_xf(cases, "xfb")))
    count_mismatch = value_mismatch = 0
    for i, c in enumerate(cases):
        ref = c["m"]
        if int(m.count[i]) != ref["count"]:
            count_mismatch += 1
            continue
        if ref["count"] == 0:
            continue
        ok = int(m.mtype[i]) == ref["mtype"]
        ok &= np.allclose(m.local_normal[i].numpy(), ref["ln"], atol=2e-5)
        ok &= np.allclose(m.local_point[i].numpy(), ref["lp"], atol=2e-4)
        for j in range(ref["count"]):
            ok &= np.allclose(m.points[i, j].numpy(), ref["pts"][j], atol=2e-4)
            ok &= int(np.uint32(m.ids[i, j].item() & 0xFFFFFFFF)) == ref["ids"][j]
        value_mismatch += not ok
    n = len(cases)
    assert count_mismatch <= max(1, n // 100), f"{count_mismatch}/{n} count mismatches"
    assert value_mismatch <= max(1, n // 100), f"{value_mismatch}/{n} value mismatches"


def test_world_manifold_matches_jax(golden_manifolds):
    import jax
    import jax.numpy as jnp
    from box2d_mt_tpu import math2d as jmath
    from box2d_mt_tpu.ops import solver as jsolver
    from box2d_mt_tpu_torch.ops import solver as tsolver

    cases = [c for c in golden_manifolds
             if c["kind"] in (nph.KIND_POLYGONS, nph.KIND_EDGE_POLYGON)
             and c["m"]["count"] > 0]
    pts = np.zeros((len(cases), 2, 2), np.float32)
    for i, c in enumerate(cases):
        pts[i, :c["m"]["count"]] = c["m"]["pts"]
    args = dict(
        mtype=np.asarray([c["m"]["mtype"] for c in cases], np.int32),
        local_point=np.asarray([c["m"]["lp"] for c in cases], np.float32),
        local_normal=np.asarray([c["m"]["ln"] for c in cases], np.float32),
        points=pts, count=np.asarray([c["m"]["count"] for c in cases], np.int32),
        ra=np.asarray([c["a"]["radius"] for c in cases], np.float32),
        rb=np.asarray([c["b"]["radius"] for c in cases], np.float32))
    xfa = np.asarray([c["xfa"] for c in cases], np.float32)
    xfb = np.asarray([c["xfb"] for c in cases], np.float32)
    want = jax.vmap(jsolver.world_manifold)(
        args["mtype"], args["local_point"], args["local_normal"], args["points"],
        args["count"], xfa[:, :2], jmath.rot_from_angle(jnp.asarray(xfa[:, 2])),
        args["ra"], xfb[:, :2], jmath.rot_from_angle(jnp.asarray(xfb[:, 2])),
        args["rb"])
    t = torch.from_numpy
    rot = lambda ang: torch.stack([torch.sin(ang), torch.cos(ang)], -1)
    got = tsolver.world_manifold(
        t(args["mtype"]), t(args["local_point"]), t(args["local_normal"]),
        t(args["points"]), t(args["count"]), t(xfa[:, :2]), rot(t(xfa[:, 2])),
        t(args["ra"]), t(xfb[:, :2]), rot(t(xfb[:, 2])), t(args["rb"]))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=2e-5)


def _random_edge_circle_lanes(n=2000, seed=11):
    """Edges with random ghost vertices (each present with probability
    0.7) and circles placed around them, past both ends as often as along
    the face, with random transforms: (rows of A, rows of B, xf A, xf B)
    as numpy arrays."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    v1 = rng.uniform(-1.0, 1.0, (n, 2))
    v2 = v1 + rng.uniform(0.5, 2.0, (n, 1)) * np.stack(
        [np.cos(t := rng.uniform(-np.pi, np.pi, n)), np.sin(t)], -1)
    e = v2 - v1
    v0 = v1 - e * rng.uniform(0.2, 1.0, (n, 1)) + rng.normal(0.0, 0.6, (n, 2))
    v3 = v2 + e * rng.uniform(0.2, 1.0, (n, 1)) + rng.normal(0.0, 0.6, (n, 2))
    ghosts = rng.random((n, 2)) < 0.7
    radius_b = rng.uniform(0.05, 0.6, n)
    # where along the edge (-0.5..1.5 of its length) and how far off it
    s = rng.uniform(-0.5, 1.5, n)
    off = rng.normal(0.0, 0.6, n)
    nrm = np.stack([-e[:, 1], e[:, 0]], -1) / np.linalg.norm(e, axis=1)[:, None]
    centre = v1 + s[:, None] * e + off[:, None] * nrm          # edge frame
    xa = np.stack([rng.uniform(-3, 3, n), rng.uniform(-3, 3, n),
                   rng.uniform(-np.pi, np.pi, n)], -1)
    ang_b = rng.uniform(-np.pi, np.pi, n)
    local_b = rng.uniform(-0.3, 0.3, (n, 2))                   # circle center on B
    ca, sa = np.cos(xa[:, 2]), np.sin(xa[:, 2])
    world = np.stack([ca * centre[:, 0] - sa * centre[:, 1] + xa[:, 0],
                      sa * centre[:, 0] + ca * centre[:, 1] + xa[:, 1]], -1)
    cb, sb = np.cos(ang_b), np.sin(ang_b)
    pb = world - np.stack([cb * local_b[:, 0] - sb * local_b[:, 1],
                           sb * local_b[:, 0] + cb * local_b[:, 1]], -1)
    xb = np.concatenate([pb, ang_b[:, None]], -1)
    verts_a = np.zeros((n, 8, 2), f32)
    verts_a[:, 0], verts_a[:, 1], verts_a[:, 2], verts_a[:, 3] = v1, v2, v0, v3
    verts_b = np.zeros((n, 8, 2), f32)
    verts_b[:, 0] = local_b
    zero_n = np.zeros((n, 8, 2), f32)
    rows_a = (verts_a, zero_n, np.full(n, 2, np.int32), ghosts,
              np.full(n, settings.POLYGON_RADIUS, f32))
    rows_b = (verts_b, zero_n, np.ones(n, np.int32), np.zeros((n, 2), bool),
              radius_b.astype(f32))
    return rows_a, rows_b, xa.astype(f32), xb.astype(f32)


def _golden_lanes(cases):
    """The golden cases' shapes and transforms as numpy rows."""
    def rows(key):
        lanes = _rows(cases, key)
        return (np.stack([lanes.vx.T.numpy(), lanes.vy.T.numpy()], -1),
                np.stack([lanes.nx.T.numpy(), lanes.ny.T.numpy()], -1),
                lanes.count.numpy(), np.stack([lanes.g0.numpy(), lanes.g1.numpy()], -1),
                lanes.radius.numpy())
    xf = lambda key: np.asarray([c[key] for c in cases], np.float32)
    return rows("a"), rows("b"), xf("xfa"), xf("xfb")


def _jax_manifold(kind, rows_a, rows_b, xa, xb):
    """The JAX package's collider of `kind`, un-jitted: the lane-major
    cores of circle-circle and polygon-circle, the per-pair edge-circle
    collider through jax.vmap."""
    import jax
    import jax.numpy as jnp
    from box2d_mt_tpu.ops import narrowphase as jnph

    def rot(x):
        a = jnp.asarray(x[:, 2])
        return jnp.stack([jnp.sin(a), jnp.cos(a)], -1)

    pa, qa, pb, qb = jnp.asarray(xa[:, :2]), rot(xa), jnp.asarray(xb[:, :2]), rot(xb)
    if kind == nph.KIND_EDGE_CIRCLE:
        to_rows = lambda r: jnph.ShapeRows(*(jnp.asarray(x) for x in r))
        m = jax.vmap(jnph.collide_edge_circle)(to_rows(rows_a), pa, qa, to_rows(rows_b), pb, qb)
    else:
        core = {nph.KIND_CIRCLES: jnph.collide_circles_core,
                nph.KIND_POLYGON_CIRCLE: jnph.collide_polygon_circle_core}[kind]
        lanes = lambda r: jnph.rows_to_lanes(jnph.ShapeRows(*(jnp.asarray(x) for x in r)))
        m = jnph.lanes_to_manifold(core(lanes(rows_a), pa[:, 0], pa[:, 1], qa[:, 0], qa[:, 1],
                                        lanes(rows_b), pb[:, 0], pb[:, 1], qb[:, 0], qb[:, 1]))
    return nph.Manifold(*(np.asarray(x) for x in m)), (qa, qb)


@pytest.mark.parametrize("kind,lanes", [
    (nph.KIND_CIRCLES, "golden"), (nph.KIND_POLYGON_CIRCLE, "golden"),
    (nph.KIND_EDGE_CIRCLE, "golden"), (nph.KIND_EDGE_CIRCLE, "random")])
def test_circle_colliders_match_jax(golden_manifolds, kind, lanes):
    if lanes == "random":
        rows_a, rows_b, xa, xb = _random_edge_circle_lanes()
    else:
        rows_a, rows_b, xa, xb = _golden_lanes(
            [c for c in golden_manifolds if c["kind"] == kind])
    want, (qa, qb) = _jax_manifold(kind, rows_a, rows_b, xa, xb)
    t = torch.from_numpy
    la = nph.lanes_from_rows(*(t(x) for x in rows_a))
    lb = nph.lanes_from_rows(*(t(x) for x in rows_b))
    q = lambda x: t(np.array(x))
    got = nph.lanes_to_manifold(nph.CORE_COLLIDERS[kind](
        la, t(xa[:, 0]), t(xa[:, 1]), q(qa[:, 0]), q(qa[:, 1]),
        lb, t(xb[:, 0]), t(xb[:, 1]), q(qb[:, 0]), q(qb[:, 1])))
    got = nph.Manifold(*(x.numpy() for x in got))
    np.testing.assert_array_equal(got.count, want.count)
    np.testing.assert_array_equal(got.mtype, want.mtype)
    hit = want.count > 0
    np.testing.assert_array_equal(got.ids[hit, 0], want.ids[hit, 0])
    for name in ("local_point", "local_normal", "points"):
        np.testing.assert_allclose(getattr(got, name)[hit], getattr(want, name)[hit],
                                   rtol=0, atol=2e-5, err_msg=name)
    if lanes == "random":
        # every region kept and rejected, and the ghost vertices rejecting
        # lanes inside the radius (b2CollideEdge.cpp:62-73, 96-107)
        v1, v2 = rows_a[0][:, 0], rows_a[0][:, 1]
        at_v1 = (got.mtype == 0) & np.all(got.local_point == v1, -1)
        at_v2 = (got.mtype == 0) & np.all(got.local_point == v2, -1)
        face = got.mtype == settings.MANIFOLD_FACE_A
        for region in (at_v1, at_v2, face):
            assert (region & hit).sum() >= 20 and (region & ~hit).sum() >= 20
        for region, ghost in ((at_v1, rows_a[3][:, 0]), (at_v2, rows_a[3][:, 1])):
            assert (region & ghost & ~hit).sum() >= 5 and (region & ~ghost & hit).sum() >= 5
