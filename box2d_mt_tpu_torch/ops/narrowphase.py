"""Narrow-phase manifolds, over lanes.

Ports of the JAX package's collider cores (`box2d_mt_tpu.ops.narrowphase`)
for all five contact kinds: circle-circle and polygon-circle
(b2CollideCircle.cpp:23-154), polygon-polygon (b2CollidePolygons,
b2CollidePolygon.cpp:114-239), edge-circle (b2CollideEdgeAndCircle,
b2CollideEdge.cpp:27-148; the JAX package has it only per pair, here it
runs over lanes with the same arithmetic) and edge-polygon (b2EPCollider,
b2CollideEdge.cpp:193-698). Every per-pair quantity is an (L,) tensor and
per-vertex data is (8, L); every C++ branch is a `torch.where`.

Contact feature ids (b2Collision.h:38-57) are packed into one int32 as
indexA | indexB<<8 | typeA<<16 | typeB<<24.
"""

from typing import NamedTuple

import torch

from .. import settings

BIG = 3.402823466e38      # b2_maxFloat
EPS = 1.1920929e-7        # b2_epsilon (FLT_EPSILON)
_TINY = 1.1754943508222875e-38

FEAT_VERTEX = 0
FEAT_FACE = 1

# Contact kind codes (the reference's s_registers, b2Contact.cpp:42-53).
KIND_CIRCLES = 0
KIND_POLYGON_CIRCLE = 1
KIND_POLYGONS = 2
KIND_EDGE_CIRCLE = 3
KIND_EDGE_POLYGON = 4
KIND_INVALID = 5  # e.g. edge-edge: no contact is created

ALL_KINDS = (KIND_CIRCLES, KIND_POLYGON_CIRCLE, KIND_POLYGONS,
             KIND_EDGE_CIRCLE, KIND_EDGE_POLYGON)


class Manifold(NamedTuple):
    """b2Manifold (b2Collision.h:93-107), leaves with a leading batch."""
    mtype: torch.Tensor          # (...) i32
    local_point: torch.Tensor    # (..., 2)
    local_normal: torch.Tensor   # (..., 2)
    points: torch.Tensor         # (..., 2, 2)
    ids: torch.Tensor            # (..., 2) i32
    count: torch.Tensor          # (...) i32


class ShapeLanes(NamedTuple):
    """A batch of fixtures in lane-major component layout."""
    vx: torch.Tensor      # (8, L) vertex x
    vy: torch.Tensor      # (8, L)
    nx: torch.Tensor      # (8, L) normal x
    ny: torch.Tensor
    count: torch.Tensor   # (L,) i32
    radius: torch.Tensor  # (L,)
    g0: torch.Tensor      # (L,) bool — edge ghost-vertex flags
    g1: torch.Tensor


class ManifoldLanes(NamedTuple):
    mtype: torch.Tensor
    lpx: torch.Tensor
    lpy: torch.Tensor
    lnx: torch.Tensor
    lny: torch.Tensor
    p0x: torch.Tensor
    p0y: torch.Tensor
    p1x: torch.Tensor
    p1y: torch.Tensor
    id0: torch.Tensor
    id1: torch.Tensor
    count: torch.Tensor


def lanes_from_rows(verts, normals, nverts, ghosts, radius) -> ShapeLanes:
    """(L, 8, 2) row-major shape data -> lane-major ShapeLanes."""
    return ShapeLanes(
        vx=verts[..., 0].T, vy=verts[..., 1].T,
        nx=normals[..., 0].T, ny=normals[..., 1].T,
        count=nverts, radius=radius, g0=ghosts[..., 0], g1=ghosts[..., 1])


def lanes_to_manifold(m: ManifoldLanes) -> Manifold:
    return Manifold(
        mtype=m.mtype,
        local_point=torch.stack([m.lpx, m.lpy], dim=-1),
        local_normal=torch.stack([m.lnx, m.lny], dim=-1),
        points=torch.stack([torch.stack([m.p0x, m.p0y], dim=-1),
                            torch.stack([m.p1x, m.p1y], dim=-1)], dim=-2),
        ids=torch.stack([m.id0, m.id1], dim=-1),
        count=m.count)


def pack_id(index_a, index_b, type_a, type_b):
    return (index_a | (index_b << 8) | (type_a << 16) | (type_b << 24)).to(torch.int32)


def flip_id(cid):
    ia = cid & 0xFF
    ib = (cid >> 8) & 0xFF
    ta = (cid >> 16) & 0xFF
    tb = (cid >> 24) & 0xFF
    return pack_id(ib, ia, tb, ta)


def _i8(ref):
    return torch.arange(settings.MAX_POLYGON_VERTICES, device=ref.device)


def _rot_s(qs, qc, x, y):
    return qc * x - qs * y, qs * x + qc * y


def _rot_t_s(qs, qc, x, y):
    return qc * x + qs * y, -qs * x + qc * y


def _sel8(idx, *arrays):
    """Per-lane row select: arrays (8, L), idx (L,) -> tuple of (L,)."""
    oh = _i8(idx)[:, None] == idx[None, :]
    return tuple(torch.sum(torch.where(oh, a, 0.0), dim=0) for a in arrays)


def _next8(idx, count):
    return torch.where(idx + 1 < count, idx + 1, 0)


def _find_max_separation_s(a: ShapeLanes, pax, pay, qas, qac,
                           b: ShapeLanes, pbx, pby, qbs, qbc):
    """b2FindMaxSeparation (b2CollidePolygon.cpp:23-62), lane-major."""
    i8 = _i8(pax)
    qs = qbc * qas - qbs * qac
    qc = qbc * qac + qbs * qas
    px, py = _rot_t_s(qbs, qbc, pax - pbx, pay - pby)
    nx, ny = _rot_s(qs, qc, a.nx, a.ny)            # (8, L)
    wx, wy = _rot_s(qs, qc, a.vx, a.vy)
    wx = wx + px
    wy = wy + py
    dx = b.vx[None, :, :] - wx[:, None, :]         # (8, 8, L)
    dy = b.vy[None, :, :] - wy[:, None, :]
    sij = nx[:, None] * dx + ny[:, None] * dy
    sij = torch.where(i8[None, :, None] < b.count[None, None, :], sij, BIG)
    si = torch.min(sij, dim=1).values              # (8, L)
    si = torch.where(i8[:, None] < a.count[None, :], si, -BIG)
    best = torch.argmax(si, dim=0).to(torch.int32)
    return best, torch.max(si, dim=0).values


def _clip_segment_s(v0x, v0y, v1x, v1y, id0, id1, nx, ny, off, vidx):
    """b2ClipSegmentToLine (b2Collision.cpp:201-232), lane-major."""
    d0 = nx * v0x + ny * v0y - off
    d1 = nx * v1x + ny * v1y - off
    denom = d0 - d1
    interp = d0 / torch.where(denom == 0.0, 1.0, denom)
    vix = v0x + interp * (v1x - v0x)
    viy = v0y + interp * (v1y - v0y)
    idi = pack_id(vidx, (id0 >> 8) & 0xFF, FEAT_VERTEX, FEAT_FACE)
    keep0 = d0 <= 0.0
    keep1 = d1 <= 0.0
    both = keep0 & keep1
    o0x = torch.where(keep0, v0x, v1x)
    o0y = torch.where(keep0, v0y, v1y)
    oid0 = torch.where(keep0, id0, id1)
    o1x = torch.where(both, v1x, vix)
    o1y = torch.where(both, v1y, viy)
    oid1 = torch.where(both, id1, idi)
    n = (keep0.to(torch.int32) + keep1.to(torch.int32)
         + (d0 * d1 < 0.0).to(torch.int32))
    return o0x, o0y, o1x, o1y, oid0, oid1, n


def collide_polygons_core(a: ShapeLanes, pax, pay, qas, qac,
                          b: ShapeLanes, pbx, pby, qbs, qbc) -> ManifoldLanes:
    """b2CollidePolygons (b2CollidePolygon.cpp:114-239), lane-major."""
    total_radius = a.radius + b.radius
    edge_a, sep_a = _find_max_separation_s(a, pax, pay, qas, qac,
                                           b, pbx, pby, qbs, qbc)
    edge_b, sep_b = _find_max_separation_s(b, pbx, pby, qbs, qbc,
                                           a, pax, pay, qas, qac)
    separated = (sep_a > total_radius) | (sep_b > total_radius)
    flip = sep_b > sep_a + 0.1 * settings.LINEAR_SLOP

    def pick(xb, xa):
        return torch.where(flip, xb, xa)

    v1x, v1y = pick(b.vx, a.vx), pick(b.vy, a.vy)
    n1x, n1y = pick(b.nx, a.nx), pick(b.ny, a.ny)
    count1 = pick(b.count, a.count)
    p1x, p1y = pick(pbx, pax), pick(pby, pay)
    q1s, q1c = pick(qbs, qas), pick(qbc, qac)
    v2x, v2y = pick(a.vx, b.vx), pick(a.vy, b.vy)
    n2x, n2y = pick(a.nx, b.nx), pick(a.ny, b.ny)
    count2 = pick(a.count, b.count)
    p2x, p2y = pick(pax, pbx), pick(pay, pby)
    q2s, q2c = pick(qas, qbs), pick(qac, qbc)
    edge1 = torch.where(flip, edge_b, edge_a)

    # b2FindIncidentEdge (b2CollidePolygon.cpp:64-112)
    en_x, en_y = _sel8(edge1, n1x, n1y)
    wn_x, wn_y = _rot_s(q1s, q1c, en_x, en_y)
    ln_x, ln_y = _rot_t_s(q2s, q2c, wn_x, wn_y)    # poly1 normal in frame2
    dots = ln_x * n2x + ln_y * n2y                 # (8, L)
    dots = torch.where(_i8(dots)[:, None] < count2[None, :], dots, BIG)
    i1 = torch.argmin(dots, dim=0).to(torch.int32)
    i2 = _next8(i1, count2)
    iv1x, iv1y = _sel8(i1, v2x, v2y)
    iv2x, iv2y = _sel8(i2, v2x, v2y)
    inc0x, inc0y = _rot_s(q2s, q2c, iv1x, iv1y)
    inc0x, inc0y = inc0x + p2x, inc0y + p2y
    inc1x, inc1y = _rot_s(q2s, q2c, iv2x, iv2y)
    inc1x, inc1y = inc1x + p2x, inc1y + p2y
    iid0 = pack_id(edge1, i1, FEAT_FACE, FEAT_VERTEX)
    iid1 = pack_id(edge1, i2, FEAT_FACE, FEAT_VERTEX)

    iv1 = edge1
    iv2 = _next8(edge1, count1)
    v11x, v11y = _sel8(iv1, v1x, v1y)
    v12x, v12y = _sel8(iv2, v1x, v1y)
    tx, ty = v12x - v11x, v12y - v11y
    tl = torch.sqrt(tx * tx + ty * ty)
    safe = torch.where(tl > 0.0, tl, 1.0)
    tx = torch.where(tl > 0.0, tx / safe, 0.0)
    ty = torch.where(tl > 0.0, ty / safe, 0.0)
    lnx, lny = ty, -tx                              # localNormal = cross(t, 1)
    plane_x, plane_y = 0.5 * (v11x + v12x), 0.5 * (v11y + v12y)
    wtx, wty = _rot_s(q1s, q1c, tx, ty)
    wnx, wny = wty, -wtx
    w11x, w11y = _rot_s(q1s, q1c, v11x, v11y)
    w11x, w11y = w11x + p1x, w11y + p1y
    w12x, w12y = _rot_s(q1s, q1c, v12x, v12y)
    w12x, w12y = w12x + p1x, w12y + p1y
    front = wnx * w11x + wny * w11y
    side1 = -(wtx * w11x + wty * w11y) + total_radius
    side2 = (wtx * w12x + wty * w12y) + total_radius

    c0x, c0y, c1x, c1y, cid0, cid1, np1 = _clip_segment_s(
        inc0x, inc0y, inc1x, inc1y, iid0, iid1, -wtx, -wty, side1, iv1)
    c0x, c0y, c1x, c1y, cid0, cid1, np2 = _clip_segment_s(
        c0x, c0y, c1x, c1y, cid0, cid1, wtx, wty, side2, iv2)
    clip_ok = (np1 >= 2) & (np2 >= 2)

    sep0 = wnx * c0x + wny * c0y - front
    sep1 = wnx * c1x + wny * c1y - front
    keep0 = sep0 <= total_radius
    keep1 = sep1 <= total_radius

    lp0x, lp0y = _rot_t_s(q2s, q2c, c0x - p2x, c0y - p2y)
    lp1x, lp1y = _rot_t_s(q2s, q2c, c1x - p2x, c1y - p2y)
    id0 = torch.where(flip, flip_id(cid0), cid0)
    id1 = torch.where(flip, flip_id(cid1), cid1)

    # pack kept points densely (reference appends at points[pointCount])
    count = keep0.to(torch.int32) + keep1.to(torch.int32)
    count = torch.where(separated | ~clip_ok, 0, count)
    return ManifoldLanes(
        mtype=torch.where(flip, settings.MANIFOLD_FACE_B,
                          settings.MANIFOLD_FACE_A).to(torch.int32),
        lpx=plane_x, lpy=plane_y, lnx=lnx, lny=lny,
        p0x=torch.where(keep0, lp0x, lp1x), p0y=torch.where(keep0, lp0y, lp1y),
        p1x=lp1x, p1y=lp1y,
        id0=torch.where(keep0, id0, id1), id1=id1,
        count=count.to(torch.int32))


def _norm2(x, y):
    ln = torch.sqrt(x * x + y * y)
    ok = ln > _TINY
    s = torch.where(ok, ln, 1.0)
    return torch.where(ok, x / s, 0.0), torch.where(ok, y / s, 0.0)


def collide_edge_polygon_core(a: ShapeLanes, pax, pay, qas, qac,
                              b: ShapeLanes, pbx, pby, qbs, qbc
                              ) -> ManifoldLanes:
    """Lane-major b2EPCollider (b2CollideEdge.cpp:193-698): all 9
    ghost-vertex cases, axis hysteresis, reference clipping."""
    i8 = _i8(pax)
    # edge frame: xf = MulT(xfA, xfB)
    xqs = qac * qbs - qas * qbc
    xqc = qac * qbc + qas * qbs
    dxp = pbx - pax
    dyp = pby - pay
    xpx = qac * dxp + qas * dyp
    xpy = -qas * dxp + qac * dyp

    valid_b = i8[:, None] < b.count[None, :]
    nbf = torch.clamp_min(b.count, 1).to(torch.float32)

    # polygon centroid in B frame, then into edge frame
    prx = torch.sum(torch.where(valid_b, b.vx, 0.0), dim=0) / nbf
    pry = torch.sum(torch.where(valid_b, b.vy, 0.0), dim=0) / nbf
    nxt = torch.where(i8[:, None] + 1 < b.count[None, :], i8[:, None] + 1, 0)
    oh_n = nxt[:, None, :] == i8[None, :, None]          # (8,8,L)
    bvx_nx = torch.sum(torch.where(oh_n, b.vx[None, :, :], 0.0), dim=1)
    bvy_nx = torch.sum(torch.where(oh_n, b.vy[None, :, :], 0.0), dim=1)
    p1x, p1y = b.vx - prx, b.vy - pry
    p2x, p2y = bvx_nx - prx, bvy_nx - pry
    d_ = p1x * p2y - p1y * p2x
    tri = torch.where(valid_b, 0.5 * d_, 0.0)
    area = torch.sum(tri, dim=0)
    safe_area = torch.where(area == 0.0, 1.0, area)
    clx = torch.sum(tri / 3.0 * (p1x + p2x) * valid_b, dim=0) / safe_area + prx
    cly = torch.sum(tri / 3.0 * (p1y + p2y) * valid_b, dim=0) / safe_area + pry
    cx = xqc * clx - xqs * cly + xpx
    cy = xqs * clx + xqc * cly + xpy

    v0x, v0y = a.vx[2], a.vy[2]
    v1x, v1y = a.vx[0], a.vy[0]
    v2x, v2y = a.vx[1], a.vy[1]
    v3x, v3y = a.vx[3], a.vy[3]
    has0, has3 = a.g0, a.g1

    e1x, e1y = _norm2(v2x - v1x, v2y - v1y)
    n1x, n1y = e1y, -e1x
    offset1 = n1x * (cx - v1x) + n1y * (cy - v1y)

    e0x, e0y = _norm2(v1x - v0x, v1y - v0y)
    n0x, n0y = e0y, -e0x
    convex1 = e0x * e1y - e0y * e1x >= 0.0
    offset0 = torch.where(has0, n0x * (cx - v0x) + n0y * (cy - v0y), 0.0)

    e2x, e2y = _norm2(v3x - v2x, v3y - v2y)
    n2x, n2y = e2y, -e2x
    convex2 = e1x * e2y - e1y * e2x > 0.0
    offset2 = torch.where(has3, n2x * (cx - v2x) + n2y * (cy - v2y), 0.0)

    # front/back classification + normal limits, all 9 cases
    # (b2EPCollider::Collide, b2CollideEdge.cpp:273-429)
    def case(front, lofx, lofy, upfx, upfy, lobx, loby, upbx, upby):
        return (front,
                torch.where(front, lofx, lobx), torch.where(front, lofy, loby),
                torch.where(front, upfx, upbx), torch.where(front, upfy, upby))

    o0, o1, o2 = offset0 >= 0.0, offset1 >= 0.0, offset2 >= 0.0
    c_cc = case(o0 | o1 | o2, n0x, n0y, n2x, n2y, -n1x, -n1y, -n1x, -n1y)
    c_c1 = case(o0 | (o1 & o2), n0x, n0y, n1x, n1y, -n2x, -n2y, -n1x, -n1y)
    c_c2 = case(o2 | (o0 & o1), n1x, n1y, n2x, n2y, -n1x, -n1y, -n0x, -n0y)
    c_nn = case(o0 & o1 & o2, n1x, n1y, n1x, n1y, -n2x, -n2y, -n0x, -n0y)

    def sel5(c, x, y):
        return tuple(torch.where(c, xi, yi) for xi, yi in zip(x, y))

    both = sel5(convex1 & convex2, c_cc,
                sel5(convex1, c_c1, sel5(convex2, c_c2, c_nn)))
    c_0c = case(o0 | o1, n0x, n0y, -n1x, -n1y, n1x, n1y, -n1x, -n1y)
    c_0n = case(o0 & o1, n1x, n1y, -n1x, -n1y, n1x, n1y, -n0x, -n0y)
    only0 = sel5(convex1, c_0c, c_0n)
    c_3c = case(o1 | o2, -n1x, -n1y, n2x, n2y, -n1x, -n1y, n1x, n1y)
    c_3n = case(o1 & o2, -n1x, -n1y, n1x, n1y, -n2x, -n2y, n1x, n1y)
    only3 = sel5(convex2, c_3c, c_3n)
    iso = case(o1, -n1x, -n1y, -n1x, -n1y, n1x, n1y, n1x, n1y)

    front, lolx, loly, upx, upy = sel5(
        has0 & has3, both, sel5(has0, only0, sel5(has3, only3, iso)))
    mnx = torch.where(front, n1x, -n1x)
    mny = torch.where(front, n1y, -n1y)

    # polygon B in edge frame
    pvx = xqc * b.vx - xqs * b.vy + xpx               # (8, L)
    pvy = xqs * b.vx + xqc * b.vy + xpy
    pnx = xqc * b.nx - xqs * b.ny
    pny = xqs * b.nx + xqc * b.ny
    radius = a.radius + b.radius

    # ComputeEdgeSeparation (b2CollideEdge.cpp:596-613)
    s_edge = mnx * (pvx - v1x) + mny * (pvy - v1y)
    edge_sep = torch.min(torch.where(valid_b, s_edge, BIG), dim=0).values

    # ComputePolygonSeparation (b2CollideEdge.cpp:615-663)
    px_, py_ = -mny, mnx                              # perp
    nnx, nny = -pnx, -pny
    s1 = nnx * (pvx - v1x) + nny * (pvy - v1y)
    s2 = nnx * (pvx - v2x) + nny * (pvy - v2y)
    s_poly = torch.minimum(s1, s2)
    poly_separated = torch.any(valid_b & (s_poly > radius), dim=0)
    adj_upper = nnx * px_ + nny * py_ >= 0.0
    limx = torch.where(adj_upper, upx, lolx)
    limy = torch.where(adj_upper, upy, loly)
    adj_ok = (nnx - limx) * mnx + (nny - limy) * mny >= -settings.ANGULAR_SLOP
    s_poly_m = torch.where(valid_b & adj_ok, s_poly, -BIG)
    poly_index = torch.argmax(s_poly_m, dim=0).to(torch.int32)
    poly_sep = torch.max(s_poly_m, dim=0).values
    poly_axis_known = torch.any(valid_b & adj_ok, dim=0)

    separated = (edge_sep > radius) | poly_separated
    use_poly = poly_axis_known & (poly_sep > 0.98 * edge_sep + 0.001)

    # --- primary axis = edgeA branch (face A)
    d_best = torch.where(valid_b, mnx * pnx + mny * pny, BIG)
    best = torch.argmin(d_best, dim=0).to(torch.int32)
    bi2 = _next8(best, b.count)
    (ie_a0x, ie_a0y), (ie_a1x, ie_a1y) = _sel8(best, pvx, pvy), _sel8(bi2, pvx, pvy)
    ie_a_id0 = pack_id(torch.zeros_like(best), best, FEAT_FACE, FEAT_VERTEX)
    ie_a_id1 = pack_id(torch.zeros_like(bi2), bi2, FEAT_FACE, FEAT_VERTEX)
    one = torch.ones_like(best)
    rf_a_i1 = torch.where(front, 0, one)
    rf_a_i2 = torch.where(front, one, 0)
    rf_a_v1x = torch.where(front, v1x, v2x)
    rf_a_v1y = torch.where(front, v1y, v2y)
    rf_a_v2x = torch.where(front, v2x, v1x)
    rf_a_v2y = torch.where(front, v2y, v1y)

    # --- primary axis = edgeB branch (face B)
    rf_b_i2 = _next8(poly_index, b.count)
    ie_b_id = pack_id(torch.zeros_like(poly_index), poly_index,
                      FEAT_VERTEX, FEAT_FACE)
    rf_b_v1x, rf_b_v1y, rf_b_nx, rf_b_ny = _sel8(poly_index, pvx, pvy, pnx, pny)
    rf_b_v2x, rf_b_v2y = _sel8(rf_b_i2, pvx, pvy)

    ie0x = torch.where(use_poly, v1x, ie_a0x)
    ie0y = torch.where(use_poly, v1y, ie_a0y)
    ie1x = torch.where(use_poly, v2x, ie_a1x)
    ie1y = torch.where(use_poly, v2y, ie_a1y)
    ie_id0 = torch.where(use_poly, ie_b_id, ie_a_id0)
    ie_id1 = torch.where(use_poly, ie_b_id, ie_a_id1)
    rf_i1 = torch.where(use_poly, poly_index, rf_a_i1)
    rf_i2 = torch.where(use_poly, rf_b_i2, rf_a_i2)
    rf_v1x = torch.where(use_poly, rf_b_v1x, rf_a_v1x)
    rf_v1y = torch.where(use_poly, rf_b_v1y, rf_a_v1y)
    rf_v2x = torch.where(use_poly, rf_b_v2x, rf_a_v2x)
    rf_v2y = torch.where(use_poly, rf_b_v2y, rf_a_v2y)
    rf_nx = torch.where(use_poly, rf_b_nx, mnx)
    rf_ny = torch.where(use_poly, rf_b_ny, mny)

    sn1x, sn1y = rf_ny, -rf_nx
    so1 = sn1x * rf_v1x + sn1y * rf_v1y
    so2 = -sn1x * rf_v2x - sn1y * rf_v2y

    c0x, c0y, c1x, c1y, cid0, cid1, np1 = _clip_segment_s(
        ie0x, ie0y, ie1x, ie1y, ie_id0, ie_id1, sn1x, sn1y, so1, rf_i1)
    c0x, c0y, c1x, c1y, cid0, cid1, np2 = _clip_segment_s(
        c0x, c0y, c1x, c1y, cid0, cid1, -sn1x, -sn1y, so2, rf_i2)
    clip_ok = (np1 >= 2) & (np2 >= 2)

    b_nx, b_ny, b_vx, b_vy = _sel8(poly_index, b.nx, b.ny, b.vx, b.vy)
    lnx = torch.where(use_poly, b_nx, rf_nx)
    lny = torch.where(use_poly, b_ny, rf_ny)
    lpx = torch.where(use_poly, b_vx, rf_v1x)
    lpy = torch.where(use_poly, b_vy, rf_v1y)

    sep0 = rf_nx * (c0x - rf_v1x) + rf_ny * (c0y - rf_v1y)
    sep1 = rf_nx * (c1x - rf_v1x) + rf_ny * (c1y - rf_v1y)
    keep0 = sep0 <= radius
    keep1 = sep1 <= radius

    # local points: faceA stores B-frame points, faceB stores edge-frame
    la0x = xqc * (c0x - xpx) + xqs * (c0y - xpy)
    la0y = -xqs * (c0x - xpx) + xqc * (c0y - xpy)
    la1x = xqc * (c1x - xpx) + xqs * (c1y - xpy)
    la1y = -xqs * (c1x - xpx) + xqc * (c1y - xpy)
    lp0x = torch.where(use_poly, c0x, la0x)
    lp0y = torch.where(use_poly, c0y, la0y)
    lp1x = torch.where(use_poly, c1x, la1x)
    lp1y = torch.where(use_poly, c1y, la1y)
    id0 = torch.where(use_poly, flip_id(cid0), cid0)
    id1 = torch.where(use_poly, flip_id(cid1), cid1)

    count = keep0.to(torch.int32) + keep1.to(torch.int32)
    count = torch.where(separated | ~clip_ok, 0, count)
    return ManifoldLanes(
        mtype=torch.where(use_poly, settings.MANIFOLD_FACE_B,
                          settings.MANIFOLD_FACE_A).to(torch.int32),
        lpx=lpx, lpy=lpy, lnx=lnx, lny=lny,
        p0x=torch.where(keep0, lp0x, lp1x), p0y=torch.where(keep0, lp0y, lp1y),
        p1x=lp1x, p1y=lp1y,
        id0=torch.where(keep0, id0, id1), id1=id1,
        count=count.to(torch.int32))


def collide_circles_core(a: ShapeLanes, pax, pay, qas, qac,
                         b: ShapeLanes, pbx, pby, qbs, qbc) -> ManifoldLanes:
    """b2CollideCircles (b2CollideCircle.cpp:23-49), lane-major."""
    cax, cay = a.vx[0], a.vy[0]
    cbx, cby = b.vx[0], b.vy[0]
    wax, way = _rot_s(qas, qac, cax, cay)
    wbx, wby = _rot_s(qbs, qbc, cbx, cby)
    dx = wbx + pbx - wax - pax
    dy = wby + pby - way - pay
    r = a.radius + b.radius
    hit = dx * dx + dy * dy <= r * r
    z = torch.zeros_like(cax)
    zi = torch.zeros_like(a.count)
    return ManifoldLanes(
        mtype=torch.full_like(a.count, settings.MANIFOLD_CIRCLES),
        lpx=cax, lpy=cay, lnx=z, lny=z,
        p0x=cbx, p0y=cby, p1x=z, p1y=z, id0=zi, id1=zi,
        count=hit.to(torch.int32))


def collide_polygon_circle_core(a: ShapeLanes, pax, pay, qas, qac,
                                b: ShapeLanes, pbx, pby, qbs, qbc) -> ManifoldLanes:
    """b2CollidePolygonAndCircle (b2CollideCircle.cpp:51-154), lane-major."""
    wx, wy = _rot_s(qbs, qbc, b.vx[0], b.vy[0])
    clx, cly = _rot_t_s(qas, qac, wx + pbx - pax, wy + pby - pay)
    r = a.radius + b.radius

    valid = _i8(pax)[:, None] < a.count[None, :]
    s = a.nx * (clx - a.vx) + a.ny * (cly - a.vy)          # (8, L)
    separated = torch.any(valid & (s > r), dim=0)
    s_masked = torch.where(valid, s, -BIG)
    separation = s_masked.amax(0)
    ni = torch.argmax(s_masked, dim=0).to(torch.int32)

    v1x, v1y, n_ix, n_iy = _sel8(ni, a.vx, a.vy, a.nx, a.ny)
    v2x, v2y = _sel8(_next8(ni, a.count), a.vx, a.vy)
    fcx, fcy = 0.5 * (v1x + v2x), 0.5 * (v1y + v2y)

    d1x, d1y = clx - v1x, cly - v1y
    d2x, d2y = clx - v2x, cly - v2y
    u1 = d1x * (v2x - v1x) + d1y * (v2y - v1y)
    u2 = d2x * (v1x - v2x) + d2y * (v1y - v2y)

    inside = separation < EPS
    nv1x, nv1y = _norm2(d1x, d1y)
    nv2x, nv2y = _norm2(d2x, d2y)
    reject_v1 = d1x * d1x + d1y * d1y > r * r
    reject_v2 = d2x * d2x + d2y * d2y > r * r
    reject_face = (clx - fcx) * n_ix + (cly - fcy) * n_iy > r

    use_v1 = ~inside & (u1 <= 0.0)
    use_v2 = ~inside & ~(u1 <= 0.0) & (u2 <= 0.0)
    use_face = ~inside & ~(u1 <= 0.0) & ~(u2 <= 0.0)

    lnx = torch.where(use_v1, nv1x, torch.where(use_v2, nv2x, n_ix))
    lny = torch.where(use_v1, nv1y, torch.where(use_v2, nv2y, n_iy))
    lpx = torch.where(use_v1, v1x, torch.where(use_v2, v2x, fcx))
    lpy = torch.where(use_v1, v1y, torch.where(use_v2, v2y, fcy))
    rejected = (separated | (use_v1 & reject_v1) | (use_v2 & reject_v2)
                | (use_face & reject_face))
    z = torch.zeros_like(lpx)
    zi = torch.zeros_like(a.count)
    return ManifoldLanes(
        mtype=torch.full_like(a.count, settings.MANIFOLD_FACE_A),
        lpx=lpx, lpy=lpy, lnx=lnx, lny=lny,
        p0x=b.vx[0], p0y=b.vy[0], p1x=z, p1y=z, id0=zi, id1=zi,
        count=torch.where(rejected, 0, 1).to(torch.int32))


def collide_edge_circle_core(a: ShapeLanes, pax, pay, qas, qac,
                             b: ShapeLanes, pbx, pby, qbs, qbc) -> ManifoldLanes:
    """b2CollideEdgeAndCircle (b2CollideEdge.cpp:27-148), lane-major: the
    JAX package's per-pair `collide_edge_circle` (its ops/narrowphase.py:
    414-470) over lanes, with its arithmetic in its order. Regions A
    (v <= 0) and B (u <= 0) give a circles manifold at the edge vertex,
    rejected behind a ghost vertex's adjacent edge; region AB a face
    manifold."""
    wx, wy = _rot_s(qbs, qbc, b.vx[0], b.vy[0])
    qx, qy = _rot_t_s(qas, qac, wx + pbx - pax, wy + pby - pay)
    vax, vay = a.vx[0], a.vy[0]
    vbx, vby = a.vx[1], a.vy[1]
    v0x, v0y = a.vx[2], a.vy[2]
    v3x, v3y = a.vx[3], a.vy[3]
    ex, ey = vbx - vax, vby - vay
    u = ex * (vbx - qx) + ey * (vby - qy)
    v = ex * (qx - vax) + ey * (qy - vay)
    r = a.radius + b.radius
    r2 = r * r

    # region A
    dax, day = qx - vax, qy - vay
    rej_a = dax * dax + day * day > r2
    e1x, e1y = vax - v0x, vay - v0y
    u1 = e1x * (vax - qx) + e1y * (vay - qy)
    rej_a = rej_a | (a.g0 & (u1 > 0.0))
    # region B
    dbx, dby = qx - vbx, qy - vby
    rej_b = dbx * dbx + dby * dby > r2
    e2x, e2y = v3x - vbx, v3y - vby
    v2 = e2x * (qx - vbx) + e2y * (qy - vby)
    rej_b = rej_b | (a.g1 & (v2 > 0.0))
    # region AB
    den = ex * ex + ey * ey
    den = torch.where(den == 0.0, 1.0, den)
    pabx = (u * vax + v * vbx) / den
    paby = (u * vay + v * vby) / den
    dabx, daby = qx - pabx, qy - paby
    rej_ab = dabx * dabx + daby * daby > r2
    nx, ny = -ey, ex
    back = nx * (qx - vax) + ny * (qy - vay) < 0.0
    nx, ny = _norm2(torch.where(back, -nx, nx), torch.where(back, -ny, ny))

    in_a = v <= 0.0
    in_b = ~in_a & (u <= 0.0)
    in_ab = ~in_a & ~in_b
    rejected = (in_a & rej_a) | (in_b & rej_b) | (in_ab & rej_ab)
    z = torch.zeros_like(qx)
    zi = torch.zeros_like(a.count)
    # feature ids: region A (0, vertex), region B (1, vertex), AB (0, face)
    cid = torch.where(in_a, FEAT_VERTEX << 16,
                      torch.where(in_b, 1 | FEAT_VERTEX << 16, FEAT_FACE << 16))
    return ManifoldLanes(
        mtype=torch.where(in_ab, settings.MANIFOLD_FACE_A,
                          settings.MANIFOLD_CIRCLES).to(torch.int32),
        lpx=torch.where(in_b, vbx, vax), lpy=torch.where(in_b, vby, vay),
        lnx=torch.where(in_ab, nx, 0.0), lny=torch.where(in_ab, ny, 0.0),
        p0x=b.vx[0], p0y=b.vy[0], p1x=z, p1y=z,
        id0=cid.to(torch.int32), id1=zi,
        count=torch.where(rejected, 0, 1).to(torch.int32))


# the lane-major core of each contact kind
CORE_COLLIDERS = {
    KIND_CIRCLES: collide_circles_core,
    KIND_POLYGON_CIRCLE: collide_polygon_circle_core,
    KIND_POLYGONS: collide_polygons_core,
    KIND_EDGE_CIRCLE: collide_edge_circle_core,
    KIND_EDGE_POLYGON: collide_edge_polygon_core,
}


class ShapeRows(NamedTuple):
    """Fixtures' shape data as gathered from the Fixtures table, one row
    per lane."""
    verts: torch.Tensor    # (L, 8, 2)
    normals: torch.Tensor  # (L, 8, 2)
    nverts: torch.Tensor   # (L,) i32
    ghosts: torch.Tensor   # (L, 2) bool
    radius: torch.Tensor   # (L,)


def collide(kind, a: ShapeRows, pA, qA, b: ShapeRows, pB, qB,
            kinds=ALL_KINDS) -> Manifold:
    """Each lane's manifold from its own kind's collider (the JAX package's
    per-pair `collide`, ops/narrowphase.py:789-808, over lanes): kind (L,),
    transforms p (L, 2), q (L, 2) of (sin, cos).

    As there, with a single kind in `kinds` every lane takes that
    collider's manifold with the count zeroed off that kind; with several,
    only the colliders of `kinds` run and a lane of any other kind gets
    the empty manifold."""
    kinds = tuple(k for k in kinds if k != KIND_INVALID)
    la = lanes_from_rows(*a)
    lb = lanes_from_rows(*b)
    xa = (pA[:, 0], pA[:, 1], qA[:, 0], qA[:, 1])
    xb = (pB[:, 0], pB[:, 1], qB[:, 0], qB[:, 1])

    def run(k):
        return lanes_to_manifold(CORE_COLLIDERS[k](la, *xa, lb, *xb))

    if len(kinds) == 1:
        man = run(kinds[0])
        return man._replace(count=torch.where(kind == kinds[0], man.count, 0))
    n = kind.shape[0]
    zi = torch.zeros(n, dtype=torch.int32, device=kind.device)
    zf = torch.zeros((n, 2), device=kind.device)
    man = Manifold(mtype=zi, local_point=zf, local_normal=zf,
                   points=torch.zeros((n, 2, 2), device=kind.device),
                   ids=torch.zeros((n, 2), dtype=torch.int32, device=kind.device),
                   count=zi)
    for k in kinds:
        mk = run(k)
        sel = kind == k
        man = Manifold(*(torch.where(sel.reshape((n,) + (1,) * (new.dim() - 1)), new, old)
                         for new, old in zip(mk, man)))
    return man


def contact_kind(type_a, type_b):
    """Map a (role-ordered) shape-type pair to a collider kind."""
    c, e, p = settings.SHAPE_CIRCLE, settings.SHAPE_EDGE, settings.SHAPE_POLYGON
    kind = torch.full_like(type_a, KIND_INVALID, dtype=torch.int32)
    kind = torch.where((type_a == c) & (type_b == c), KIND_CIRCLES, kind)
    kind = torch.where((type_a == p) & (type_b == c), KIND_POLYGON_CIRCLE, kind)
    kind = torch.where((type_a == p) & (type_b == p), KIND_POLYGONS, kind)
    kind = torch.where((type_a == e) & (type_b == c), KIND_EDGE_CIRCLE, kind)
    kind = torch.where((type_a == e) & (type_b == p), KIND_EDGE_POLYGON, kind)
    return kind.to(torch.int32)


def needs_swap(type_i, type_j):
    """True when fixture j must take the A role (reference registration
    order: polygon before circle, edge before circle, edge before polygon)."""
    c, e, p = settings.SHAPE_CIRCLE, settings.SHAPE_EDGE, settings.SHAPE_POLYGON
    return (((type_i == c) & (type_j == p))
            | ((type_i == c) & (type_j == e))
            | ((type_i == p) & (type_j == e)))
