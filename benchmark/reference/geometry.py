"""Shapes, mass and contact manifolds of Box2D 2.3.1, written from its
semantics in plain PyTorch (float64 by default), batched over pairs.

Sources, by file of Box2D v2.3.1: b2PolygonShape.cpp (SetAsBox,
ComputeMass, ComputeAABB), b2EdgeShape.cpp, b2CollidePolygon.cpp
(b2FindMaxSeparation, b2FindIncidentEdge, b2CollidePolygons),
b2CollideEdge.cpp (b2EPCollider::Collide for an edge without ghost
vertices), b2Collision.cpp (b2ClipSegmentToLine, b2WorldManifold), and
b2ContactFeature's key: indexA | indexB << 8 | typeA << 16 | typeB << 24.

Every discontinuous decision of a collider (a point kept or dropped at the
contact distance, a reference face chosen over another, a clip point on
its plane) also returns its margin: how far the deciding quantity lay from
its threshold. The check leaves out a world's step where a margin is
within the rounding of float32 coordinates, since there a sound float32
program may decide the other way."""

import math

import torch

LINEAR_SLOP = 0.005
POLYGON_RADIUS = 2.0 * LINEAR_SLOP
ANGULAR_SLOP = 2.0 / 180.0 * math.pi
E_VERTEX, E_FACE = 0, 1
FACE_A, FACE_B = 1, 2          # b2Manifold::Type (e_circles = 0)
EDGE, POLYGON = 1, 2           # b2Shape::Type
STATIC, DYNAMIC = 0, 2         # b2BodyType
BIG = 1e30


# ---------------------------------------------------------------- shapes

def box(hx: float, hy: float):
    """b2PolygonShape::SetAsBox: vertices counter-clockwise from (-hx, -hy)."""
    verts = [(-hx, -hy), (hx, -hy), (hx, hy), (-hx, hy)]
    return {"type": POLYGON, "verts": verts, "normals": polygon_normals(verts),
            "radius": POLYGON_RADIUS}


def edge(v1, v2):
    return {"type": EDGE, "verts": [tuple(v1), tuple(v2)], "normals": [],
            "radius": POLYGON_RADIUS}


def polygon_normals(verts):
    out = []
    for i, (x1, y1) in enumerate(verts):
        x2, y2 = verts[(i + 1) % len(verts)]
        ex, ey = x2 - x1, y2 - y1
        ln = math.hypot(ex, ey)
        out.append((ey / ln, -ex / ln))
    return out


def polygon_mass(verts, density: float):
    """b2PolygonShape::ComputeMass: (mass, center, inertia about the
    shape's origin), triangles from the vertices' mean."""
    n = len(verts)
    sx = sum(v[0] for v in verts) / n
    sy = sum(v[1] for v in verts) / n
    area = cx = cy = inertia = 0.0
    for i in range(n):
        e1x, e1y = verts[i][0] - sx, verts[i][1] - sy
        e2x, e2y = verts[(i + 1) % n][0] - sx, verts[(i + 1) % n][1] - sy
        d = e1x * e2y - e1y * e2x
        tri = 0.5 * d
        area += tri
        cx += tri / 3.0 * (e1x + e2x)
        cy += tri / 3.0 * (e1y + e2y)
        inertia += (0.25 / 3.0 * d) * ((e1x * e1x + e2x * e1x + e2x * e2x)
                                       + (e1y * e1y + e2y * e1y + e2y * e2y))
    mass = density * area
    cx, cy = cx / area, cy / area
    center = (cx + sx, cy + sy)
    inertia = density * inertia + mass * (center[0] ** 2 + center[1] ** 2 - cx * cx - cy * cy)
    return mass, center, inertia


def polygon_centroid(verts):
    _, center, _ = polygon_mass(verts, 1.0)
    return center


# ------------------------------------------------------------ transforms

def rot(s, c, x, y):
    return c * x - s * y, s * x + c * y


def rot_t(s, c, x, y):
    return c * x + s * y, -s * x + c * y


def mul_t_xf(pa, sa, ca, pb, sb, cb):
    """b2MulT(A, B): B in A's frame, as (p, s, c)."""
    s = ca * sb - sa * cb
    c = ca * cb + sa * sb
    px, py = rot_t(sa, ca, pb[..., 0] - pa[..., 0], pb[..., 1] - pa[..., 1])
    return torch.stack([px, py], -1), s, c


def apply_xf(p, s, c, v):
    """b2Mul(xf, v) for v (..., K, 2) and a transform of shape (...)."""
    x, y = rot(s[..., None], c[..., None], v[..., 0], v[..., 1])
    return torch.stack([x + p[..., None, 0], y + p[..., None, 1]], -1)


def apply_rot(s, c, v):
    x, y = rot(s[..., None], c[..., None], v[..., 0], v[..., 1])
    return torch.stack([x, y], -1)


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]


def cross_vs(v, s):
    """b2Cross(v, s) = (s * v.y, -s * v.x)."""
    return torch.stack([s * v[..., 1], -s * v[..., 0]], -1)


def normalize(v):
    ln = torch.sqrt(dot(v, v))
    return v / torch.where(ln > 0, ln, 1.0)[..., None]


def take(x, idx):
    """x (P, K, ...) at idx (P,) along K."""
    return x[torch.arange(x.shape[0], device=x.device), idx]


def next_index(i, count):
    return torch.where(i + 1 < count, i + 1, 0)


# ---------------------------------------------------------- feature keys

def key(ia, ib, ta, tb):
    return ia | (ib << 8) | (ta << 16) | (tb << 24)


def flip_key(k):
    ia, ib = k & 0xFF, (k >> 8) & 0xFF
    ta, tb = (k >> 16) & 0xFF, (k >> 24) & 0xFF
    return key(ib, ia, tb, ta)


# ------------------------------------------------------------- clipping

def clip(v, ids, normal, offset, vertex_index_a):
    """b2ClipSegmentToLine over pairs: v (P, 2, 2), ids (P, 2) int64,
    normal (P, 2), offset (P,), vertex_index_a (P,). Returns (points
    (P, 2, 2), ids (P, 2), count (P,), margin (P,)): the margin is the
    smaller |distance| of the two vertices to the line."""
    d0 = dot(normal, v[:, 0]) - offset
    d1 = dot(normal, v[:, 1]) - offset
    keep0, keep1 = d0 <= 0.0, d1 <= 0.0
    crosses = d0 * d1 < 0.0
    t = d0 / torch.where(crosses, d0 - d1, 1.0)
    vi = v[:, 0] + t[:, None] * (v[:, 1] - v[:, 0])
    idi = key(vertex_index_a, (ids[:, 0] >> 8) & 0xFF,
              torch.full_like(ids[:, 0], E_VERTEX), torch.full_like(ids[:, 0], E_FACE))
    # out[0]: v0 if kept, else v1 if kept, else the crossing
    first_v = torch.where(keep0[:, None], v[:, 0], torch.where(keep1[:, None], v[:, 1], vi))
    first_id = torch.where(keep0, ids[:, 0], torch.where(keep1, ids[:, 1], idi))
    # out[1]: v1 if both kept, else the crossing
    second_v = torch.where((keep0 & keep1)[:, None], v[:, 1], vi)
    second_id = torch.where(keep0 & keep1, ids[:, 1], idi)
    count = keep0.long() + keep1.long() + crosses.long()
    return (torch.stack([first_v, second_v], 1), torch.stack([first_id, second_id], 1),
            count, torch.minimum(d0.abs(), d1.abs()))


# ----------------------------------------------------------- manifolds

class Manifold:
    """Manifolds of P pairs: type (P,), local_normal (P, 2), local_point
    (P, 2), points (P, 2, 2) local to the pair's body B (face A) or A
    (face B), ids (P, 2) int64, count (P,), and margin (P,): the least
    margin of the pair's discontinuous decisions."""

    def __init__(self, mtype, local_normal, local_point, points, ids, count, margin):
        self.mtype, self.local_normal, self.local_point = mtype, local_normal, local_point
        self.points, self.ids, self.count, self.margin = points, ids, count, margin


def _second_gap(x, best, pick_max: bool):
    """|best value - the next best| over the last axis (x masked to +-BIG)."""
    if x.shape[-1] < 2:
        return torch.full(x.shape[:-1], BIG, dtype=x.dtype, device=x.device)
    srt = torch.sort(x, dim=-1, descending=pick_max).values
    return (srt[..., 0] - srt[..., 1]).abs()


def find_max_separation(v1, n1, cnt1, p1, s1, c1, v2, cnt2, p2, s2, c2):
    """b2FindMaxSeparation: (separation, edge of poly1, margin of the choice)."""
    p, s, c = mul_t_xf(p2, s2, c2, p1, s1, c1)          # poly1 in poly2's frame
    n = apply_rot(s, c, n1)                              # (P, K1, 2)
    v = apply_xf(p, s, c, v1)
    k1, k2 = v1.shape[1], v2.shape[1]
    sij = (n[:, :, None, 0] * (v2[:, None, :, 0] - v[:, :, None, 0])
           + n[:, :, None, 1] * (v2[:, None, :, 1] - v[:, :, None, 1]))
    j_ok = torch.arange(k2, device=v1.device)[None, None, :] < cnt2[:, None, None]
    si = torch.where(j_ok, sij, BIG).amin(-1)
    i_ok = torch.arange(k1, device=v1.device)[None, :] < cnt1[:, None]
    si = torch.where(i_ok, si, -BIG)
    best = torch.argmax(si, dim=1)                       # first of equal maxima
    return take(si, best), best, _second_gap(si, best, True)


def incident_edge(n1_ref, p1, s1, c1, v2, n2, cnt2, p2, s2, c2, edge1):
    """b2FindIncidentEdge: the two clip vertices (P, 2, 2) in world
    coordinates, their ids, and the margin of the choice."""
    wx, wy = rot(s1, c1, n1_ref[:, 0], n1_ref[:, 1])
    nx, ny = rot_t(s2, c2, wx, wy)
    dots = nx[:, None] * n2[..., 0] + ny[:, None] * n2[..., 1]
    ok = torch.arange(v2.shape[1], device=v2.device)[None, :] < cnt2[:, None]
    dots = torch.where(ok, dots, BIG)
    i1 = torch.argmin(dots, dim=1)
    i2 = next_index(i1, cnt2)
    w = apply_xf(p2, s2, c2, torch.stack([take(v2, i1), take(v2, i2)], 1))
    face, vert = torch.full_like(i1, E_FACE), torch.full_like(i1, E_VERTEX)
    ids = torch.stack([key(edge1, i1, face, vert), key(edge1, i2, face, vert)], 1)
    return w, ids, _second_gap(dots, i1, False)


def collide_polygons(a, pa, sa, ca, b, pb, sb, cb, prefer=None, band=0.0) -> Manifold:
    """b2CollidePolygons over pairs; `a`, `b` are dicts of per-pair shape
    tensors: verts (P, K, 2), normals (P, K, 2), count (P,), radius (P,).
    `prefer` (P,): a manifold type (FACE_A, FACE_B, or -1 for none) to
    take where the choice between A's face and B's lies within `band` of
    its k_tol hysteresis, which stacked boxes tilted by ~1e-3 rad meet
    often; that choice then leaves no margin."""
    total = a["radius"] + b["radius"]
    sep_a, edge_a, m_a = find_max_separation(a["verts"], a["normals"], a["count"], pa, sa, ca,
                                             b["verts"], b["count"], pb, sb, cb)
    sep_b, edge_b, m_b = find_max_separation(b["verts"], b["normals"], b["count"], pb, sb, cb,
                                             a["verts"], a["count"], pa, sa, ca)
    past = torch.maximum(sep_a, sep_b) - total          # > 0: apart
    apart = past > 0.0
    k_tol = 0.1 * LINEAR_SLOP
    flip = sep_b > sep_a + k_tol
    hyst = (sep_b - sep_a - k_tol).abs()
    if prefer is not None:
        adopt = (hyst < band) & (prefer >= 0)
        flip = torch.where(adopt, prefer == FACE_B, flip)
        hyst = torch.where(adopt, BIG, hyst)
    margin = torch.minimum(-past, hyst)
    margin = torch.minimum(margin, torch.where(flip, m_b, m_a))

    def pick(x_b, x_a):
        f = flip.reshape(flip.shape + (1,) * (x_a.dim() - 1))
        return torch.where(f, x_b, x_a)

    v1, n1 = pick(b["verts"], a["verts"]), pick(b["normals"], a["normals"])
    v2, n2 = pick(a["verts"], b["verts"]), pick(a["normals"], b["normals"])
    cnt1, cnt2 = pick(b["count"], a["count"]), pick(a["count"], b["count"])
    p1, s1, c1 = pick(pb, pa), pick(sb, sa), pick(cb, ca)
    p2, s2, c2 = pick(pa, pb), pick(sa, sb), pick(ca, cb)
    edge1 = pick(edge_b, edge_a)

    inc, inc_ids, m_inc = incident_edge(take(n1, edge1), p1, s1, c1, v2, n2, cnt2, p2, s2, c2, edge1)
    margin = torch.minimum(margin, m_inc)
    iv1 = edge1
    iv2 = next_index(edge1, cnt1)
    v11, v12 = take(v1, iv1), take(v1, iv2)
    local_tangent = normalize(v12 - v11)
    local_normal = cross_vs(local_tangent, torch.ones_like(total))
    plane_point = 0.5 * (v11 + v12)
    tx, ty = rot(s1, c1, local_tangent[:, 0], local_tangent[:, 1])
    tangent = torch.stack([tx, ty], -1)
    normal = cross_vs(tangent, torch.ones_like(total))
    w11 = apply_xf(p1, s1, c1, v11[:, None])[:, 0]
    w12 = apply_xf(p1, s1, c1, v12[:, None])[:, 0]
    front = dot(normal, w11)
    side1 = -dot(tangent, w11) + total
    side2 = dot(tangent, w12) + total
    cp1, id1, n1c, m1 = clip(inc, inc_ids, -tangent, side1, iv1)
    cp2, id2, n2c, m2 = clip(cp1, id1, tangent, side2, iv2)
    clipped = (n1c >= 2) & (n2c >= 2)
    margin = torch.minimum(margin, torch.minimum(m1, torch.where(n1c >= 2, m2, BIG)))
    sep = normal[:, None, 0] * cp2[..., 0] + normal[:, None, 1] * cp2[..., 1] - front[:, None]
    inside = sep <= total[:, None]
    margin = torch.minimum(margin, torch.where(clipped, (sep - total[:, None]).abs().amin(1), BIG))
    lp = torch.stack(rot_t(s2[:, None], c2[:, None], cp2[..., 0] - p2[:, None, 0],
                           cp2[..., 1] - p2[:, None, 1]), -1)
    ids = torch.where(flip[:, None], flip_key(id2), id2)
    m = _compact(lp, ids, inside & clipped[:, None] & ~apart[:, None])
    mtype = torch.where(flip, FACE_B, FACE_A)
    margin = torch.where(apart, past, margin)
    return Manifold(mtype, local_normal, plane_point, m[0], m[1], m[2], margin)


def _compact(points, ids, keep):
    """Kept points first, in order: (points, ids, count)."""
    first = keep[:, 0]
    p0 = torch.where(first[:, None], points[:, 0], points[:, 1])
    i0 = torch.where(first, ids[:, 0], ids[:, 1])
    both = keep[:, 0] & keep[:, 1]
    p1 = torch.where(both[:, None], points[:, 1], torch.zeros_like(points[:, 1]))
    i1 = torch.where(both, ids[:, 1], torch.zeros_like(ids[:, 1]))
    p0 = torch.where((keep.any(1))[:, None], p0, torch.zeros_like(p0))
    i0 = torch.where(keep.any(1), i0, torch.zeros_like(i0))
    return torch.stack([p0, p1], 1), torch.stack([i0, i1], 1), keep.long().sum(1)


def collide_edge_polygon(e, pa, sa, ca, b, pb, sb, cb) -> Manifold:
    """b2EPCollider::Collide for an edge without ghost vertices (A) and a
    polygon (B); `e` holds v1, v2 (P, 2) of the edge, `b` the polygon's
    verts, normals, count and centroid (P, 2)."""
    radius = 2.0 * POLYGON_RADIUS
    p, s, c = mul_t_xf(pa, sa, ca, pb, sb, cb)          # B in A's frame
    centroid = apply_xf(p, s, c, b["centroid"][:, None])[:, 0]
    v1, v2 = e["v1"], e["v2"]
    edge1 = normalize(v2 - v1)
    normal1 = torch.stack([edge1[:, 1], -edge1[:, 0]], -1)
    offset1 = dot(normal1, centroid - v1)
    front = offset1 >= 0.0
    normal = torch.where(front[:, None], normal1, -normal1)
    lower = upper = -normal
    margin = offset1.abs()
    vb = apply_xf(p, s, c, b["verts"])
    nb = apply_rot(s, c, b["normals"])
    k = vb.shape[1]
    ok = torch.arange(k, device=vb.device)[None, :] < b["count"][:, None]

    # the edge's axis
    s_edge = torch.where(ok, dot(normal[:, None], vb - v1[:, None]), BIG).amin(1)
    # the polygon's axes
    n = -nb
    s_poly = torch.minimum(dot(n, vb - v1[:, None]), dot(n, vb - v2[:, None]))
    separated = (ok & (s_poly > radius)).any(1)
    perp = torch.stack([-normal[:, 1], normal[:, 0]], -1)
    up = dot(n, perp[:, None]) >= 0.0
    skip = torch.where(up, dot(n - upper[:, None], normal[:, None]) < -ANGULAR_SLOP,
                       dot(n - lower[:, None], normal[:, None]) < -ANGULAR_SLOP)
    cand = torch.where(ok & ~skip, s_poly, -BIG)
    poly_index = torch.argmax(cand, 1)
    poly_sep = take(cand, poly_index)
    poly_known = (ok & ~skip).any(1)
    past = torch.maximum(s_edge, torch.where(ok, s_poly, -BIG).amax(1)) - radius
    apart = (s_edge > radius) | separated
    use_poly = poly_known & (poly_sep > 0.98 * s_edge + 0.001)
    margin = torch.minimum(margin, -past)
    margin = torch.minimum(margin, torch.where(poly_known, (poly_sep - 0.98 * s_edge - 0.001).abs(), BIG))
    margin = torch.minimum(margin, torch.where(use_poly, _second_gap(cand, poly_index, True), BIG))

    # incident and reference, edge axis
    dots = torch.where(ok, dot(normal[:, None], nb), BIG)
    best = torch.argmin(dots, 1)
    margin = torch.minimum(margin, torch.where(use_poly, BIG, _second_gap(dots, best, False)))
    i1, i2 = best, next_index(best, b["count"])
    zero = torch.zeros_like(best)
    face, vert = torch.full_like(best, E_FACE), torch.full_like(best, E_VERTEX)
    ie_a = torch.stack([take(vb, i1), take(vb, i2)], 1)
    id_a = torch.stack([key(zero, i1, face, vert), key(zero, i2, face, vert)], 1)
    rf_i1_a = torch.where(front, 0, 1)
    rf_i2_a = torch.where(front, 1, 0)
    rf_v1_a = torch.where(front[:, None], v1, v2)
    rf_v2_a = torch.where(front[:, None], v2, v1)
    rf_n_a = torch.where(front[:, None], normal1, -normal1)
    # incident and reference, polygon axis
    ie_b = torch.stack([v1, v2], 1)
    id_b = torch.stack([key(zero, poly_index, vert, face)] * 2, 1)
    rf_i1_b = poly_index
    rf_i2_b = next_index(poly_index, b["count"])
    rf_v1_b, rf_v2_b, rf_n_b = take(vb, rf_i1_b), take(vb, rf_i2_b), take(nb, rf_i1_b)

    u = use_poly[:, None]
    ie = torch.where(u[..., None], ie_b, ie_a)
    ids = torch.where(u, id_b, id_a)
    rf_i1 = torch.where(use_poly, rf_i1_b, rf_i1_a)
    rf_i2 = torch.where(use_poly, rf_i2_b, rf_i2_a)
    rf_v1 = torch.where(u, rf_v1_b, rf_v1_a)
    rf_v2 = torch.where(u, rf_v2_b, rf_v2_a)
    rf_n = torch.where(u, rf_n_b, rf_n_a)
    side_n1 = torch.stack([rf_n[:, 1], -rf_n[:, 0]], -1)
    side_o1 = dot(side_n1, rf_v1)
    side_n2 = -side_n1
    side_o2 = dot(side_n2, rf_v2)
    cp1, id1, n1c, m1 = clip(ie, ids, side_n1, side_o1, rf_i1)
    cp2, id2, n2c, m2 = clip(cp1, id1, side_n2, side_o2, rf_i2)
    clipped = (n1c >= 2) & (n2c >= 2)
    margin = torch.minimum(margin, torch.minimum(m1, torch.where(n1c >= 2, m2, BIG)))
    sep = rf_n[:, None, 0] * (cp2[..., 0] - rf_v1[:, None, 0]) \
        + rf_n[:, None, 1] * (cp2[..., 1] - rf_v1[:, None, 1])
    inside = sep <= radius
    margin = torch.minimum(margin, torch.where(clipped, (sep - radius).abs().amin(1), BIG))
    # points: in B's frame (edge axis) or A's (polygon axis)
    lp_a = torch.stack(rot_t(s[:, None], c[:, None], cp2[..., 0] - p[:, None, 0],
                             cp2[..., 1] - p[:, None, 1]), -1)
    lp = torch.where(u[..., None], cp2, lp_a)
    pid = torch.where(u, flip_key(id2), id2)
    m = _compact(lp, pid, inside & (clipped & ~apart)[:, None])
    local_normal = torch.where(u, take(b["normals"], rf_i1_b), rf_n_a)
    local_point = torch.where(u, take(b["verts"], rf_i1_b), rf_v1_a)
    mtype = torch.where(use_poly, FACE_B, FACE_A)
    margin = torch.where(apart, past, margin)
    return Manifold(mtype, local_normal, local_point, m[0], m[1], m[2], margin)


# --------------------------------------------------------- distances

def point_segment_distance(p, a, b):
    """|p - closest point of segment ab|, p (..., 2), a, b broadcastable."""
    ab = b - a
    t = (dot(p - a, ab) / torch.clamp_min(dot(ab, ab), 1e-300)).clamp(0.0, 1.0)
    d = p - (a + t[..., None] * ab)
    return torch.sqrt(dot(d, d))


def segments_cross(a, b, c, d):
    """Whether segments ab and cd intersect (proper or touching)."""
    def orient(p, q, r):
        return (q[..., 0] - p[..., 0]) * (r[..., 1] - p[..., 1]) \
            - (q[..., 1] - p[..., 1]) * (r[..., 0] - p[..., 0])
    o1, o2 = orient(a, b, c), orient(a, b, d)
    o3, o4 = orient(c, d, a), orient(c, d, b)
    return (o1 * o2 <= 0) & (o3 * o4 <= 0)


def polygon_segment_distance(verts, count, a, b):
    """Distance of the core polygon (world verts (P, K, 2), count) to the
    segment ab (P, 2): 0 where they meet."""
    k = verts.shape[1]
    ok = torch.arange(k, device=verts.device)[None, :] < count[:, None]
    nxt = torch.stack([verts[:, (i + 1) % k] for i in range(k)], 1)
    nxt = torch.where((torch.arange(k, device=verts.device)[None, :] + 1 < count[:, None])[..., None],
                      nxt, verts[:, :1].expand_as(verts))
    d_vert = torch.where(ok, point_segment_distance(verts, a[:, None], b[:, None]), BIG).amin(1)
    d_a = torch.where(ok, point_segment_distance(a[:, None], verts, nxt), BIG).amin(1)
    d_b = torch.where(ok, point_segment_distance(b[:, None], verts, nxt), BIG).amin(1)
    meet = (ok & segments_cross(verts, nxt, a[:, None], b[:, None])).any(1)
    return torch.where(meet, 0.0, torch.minimum(d_vert, torch.minimum(d_a, d_b)))
