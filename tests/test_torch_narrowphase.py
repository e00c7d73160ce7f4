"""The port's polygon and edge-polygon colliders against the reference
golden manifolds (tests/golden/manifolds.jsonl), judged as
tests/test_narrowphase.py judges the JAX package."""

import numpy as np
import pytest
import torch

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
        if s["type"] == "polygon":
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


@pytest.mark.parametrize("kind", [nph.KIND_POLYGONS, nph.KIND_EDGE_POLYGON])
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
