"""Ray casts and AABB queries, batched over worlds.

Port of `box2d_mt_tpu.ops.raycast`: the shape ray casts
(b2CircleShape.cpp:84-120, b2PolygonShape.cpp RayCast,
b2EdgeShape.cpp:30-91) and the b2World::RayCast / QueryAABB traversals
(b2World.cpp:1752-1795) as one pass over every fixture of every world;
results come back as tensors with a leading world axis (W, F) instead of
callbacks. A ray's end points are (2,) for every world or (W, 2).
"""

from typing import NamedTuple

import torch

from .. import settings
from ..math2d import body_xf, dot, normalize, rot_t_vec, rot_vec, take

BIG = 3.402823466e38


class RayHit(NamedTuple):
    hit: torch.Tensor       # (W, F) bool
    fraction: torch.Tensor  # (W, F) f32 in [0, max_fraction], BIG where missed
    point: torch.Tensor     # (W, F, 2) world hit point
    normal: torch.Tensor    # (W, F, 2) world normal


def _raycast_circle(center_l, radius, p1, p2, max_fraction):
    """b2CircleShape::RayCast (b2CircleShape.cpp:84-120), local frame."""
    s = p1 - center_l
    b = dot(s, s) - radius * radius
    r = p2 - p1
    c = dot(s, r)
    rr = dot(r, r)
    sigma = c * c - rr * b
    ok = (sigma >= 0.0) & (rr >= 1.1920929e-7)
    t = -(c + torch.sqrt(torch.clamp_min(sigma, 0.0)))
    ok = ok & (0.0 <= t) & (t <= max_fraction * rr)
    t = t / torch.where(rr > 0.0, rr, 1.0)
    normal, _ = normalize(s + t[..., None] * r)
    return ok, t, normal


def _raycast_polygon(verts, normals, count, p1, p2, max_fraction):
    """b2PolygonShape::RayCast: half-plane clipping, local frame. verts
    and normals (..., 8, 2), the ray (..., 2)."""
    d = p2 - p1
    i8 = torch.arange(settings.MAX_POLYGON_VERTICES, device=verts.device)
    valid = i8 < count[..., None]
    num = dot(normals, verts - p1[..., None, :])                    # (..., 8)
    den = dot(normals, d[..., None, :])
    t = num / torch.where(den != 0.0, den, 1.0)
    # entering planes raise the lower bound; exiting planes cut the upper
    entering = valid & (den < 0.0)
    exiting = valid & (den > 0.0)
    parallel_out = valid & (den == 0.0) & (num < 0.0)
    lower = torch.clamp_min(torch.where(entering, t, -BIG).amax(-1), 0.0)
    idx = torch.argmax((entering & (t == lower[..., None])).to(torch.int8), -1)
    upper = torch.where(exiting, t, BIG).amin(-1).clamp_max(max_fraction)
    has_lower = (entering & (t >= lower[..., None])).any(-1)
    ok = (~parallel_out.any(-1) & (lower <= upper) & has_lower
          & (lower >= 0.0) & (lower <= max_fraction))
    return ok, lower, torch.gather(normals, -2, idx[..., None, None].expand(
        idx.shape + (1, 2)))[..., 0, :]


def _raycast_edge(v1, v2, p1, p2, max_fraction):
    """b2EdgeShape::RayCast (b2EdgeShape.cpp:30-91), local frame."""
    d = p2 - p1
    e = v2 - v1
    normal, _ = normalize(torch.stack([e[..., 1], -e[..., 0]], -1))
    num = dot(normal, v1 - p1)
    den = dot(normal, d)
    ok = den != 0.0
    t = num / torch.where(den != 0.0, den, 1.0)
    ok = ok & (t >= 0.0) & (t <= max_fraction)
    q = p1 + t[..., None] * d
    ee = dot(e, e)
    s = dot(q - v1, e) / torch.where(ee > 0.0, ee, 1.0)
    ok = ok & (ee > 0.0) & (s >= 0.0) & (s <= 1.0)
    normal = torch.where((dot(normal, d) > 0.0)[..., None], -normal, normal)
    return ok, t, normal


def raycast_fixture(shape_type, verts, normals, nverts, radius, p, q, p1, p2,
                    max_fraction):
    """Ray cast fixtures (leading axes ...) by a world-frame ray (..., 2).
    Returns RayHit."""
    lp1 = rot_t_vec(q, p1 - p)
    lp2 = rot_t_vec(q, p2 - p)
    ok_c, t_c, n_c = _raycast_circle(verts[..., 0, :], radius, lp1, lp2, max_fraction)
    ok_p, t_p, n_p = _raycast_polygon(verts, normals, nverts, lp1, lp2, max_fraction)
    ok_e, t_e, n_e = _raycast_edge(verts[..., 0, :], verts[..., 1, :], lp1, lp2,
                                   max_fraction)
    is_c = shape_type == settings.SHAPE_CIRCLE
    is_e = shape_type == settings.SHAPE_EDGE
    ok = torch.where(is_c, ok_c, torch.where(is_e, ok_e, ok_p))
    t = torch.where(is_c, t_c, torch.where(is_e, t_e, t_p))
    n_local = torch.where(is_c[..., None], n_c, torch.where(is_e[..., None], n_e, n_p))
    point = p1 + t[..., None] * (p2 - p1)
    return RayHit(hit=ok, fraction=torch.where(ok, t, BIG), point=point,
                  normal=rot_vec(q, n_local))


def _ray_end(state, point):
    """A ray end point as (W, 1, 2) on the state's device."""
    t = torch.as_tensor(point, dtype=torch.float32, device=state.gravity.device)
    return t.expand(state.n_worlds, 2)[:, None] if t.dim() == 1 else t[:, None]


def ray_cast_all(state, p1, p2, max_fraction=1.0) -> RayHit:
    """Ray cast against every fixture of every world: RayHit with (W, F)
    leading axes, the functional replacement for b2RayCastCallback
    enumeration."""
    fx, bodies = state.fixtures, state.bodies
    p, q = body_xf(bodies.c, bodies.a, bodies.local_center)
    fb = fx.body.clamp_min(0).long()
    p1, p2 = _ray_end(state, p1), _ray_end(state, p2)
    hits = raycast_fixture(fx.shape_type, fx.verts, fx.normals, fx.nverts, fx.radius,
                           take(p, fb), take(q, fb), p1, p2, float(max_fraction))
    alive = fx.exists & take(bodies.enabled, fb)
    return RayHit(hit=hits.hit & alive, fraction=torch.where(alive, hits.fraction, BIG),
                  point=hits.point, normal=hits.normal)


def ray_cast_closest(state, p1, p2, max_fraction=1.0):
    """b2World::RayCast with a closest-hit callback, per world: (hit (W,),
    fixture index (W,) i32 or -1, point (W, 2), normal (W, 2), fraction
    (W,))."""
    hits = ray_cast_all(state, p1, p2, max_fraction)
    idx = torch.argmin(hits.fraction, 1)
    hit = take(hits.hit, idx[:, None])[:, 0]
    return (hit, torch.where(hit, idx, -1).to(torch.int32),
            take(hits.point, idx[:, None])[:, 0], take(hits.normal, idx[:, None])[:, 0],
            take(hits.fraction, idx[:, None])[:, 0])


def query_aabb(state, lower, upper, use_fat: bool = True):
    """b2World::QueryAABB: (W, F) mask of the fixtures whose (fat)
    broad-phase AABB overlaps the query box, the reference's tree query
    over fattened proxies; `use_fat=False` tests the tight AABBs."""
    from .broadphase import tight_aabbs
    fx = state.fixtures
    lower, upper = _ray_end(state, lower), _ray_end(state, upper)
    if use_fat:
        lo, hi = fx.aabb_lo, fx.aabb_hi
    else:
        p, q = body_xf(state.bodies.c, state.bodies.a, state.bodies.local_center)
        fb = fx.body.clamp_min(0).long()
        lo, hi = tight_aabbs(fx, take(p, fb), take(q, fb))
    return torch.all((lo <= upper) & (lower <= hi), -1) & fx.exists
