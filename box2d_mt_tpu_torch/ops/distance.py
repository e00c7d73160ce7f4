"""GJK distance and conservative-advancement time of impact, over lanes.

Port of `box2d_mt_tpu.ops.distance` (b2Distance.cpp:452-606,
b2TimeOfImpact.cpp:256-497) for the TOI phase. Every function takes a
leading lane axis: proxies are verts (L, 8, 2), counts (L,) i32 and radii
(L,); transforms are p (L, 2) and q (L, 2) of (sin, cos).

The JAX package's bounded `lax.while_loop`s (vmapped over lanes) become
Python loops over the lane batch that stop when every lane is done, with
one host read per trip; a lane that is done is frozen, so each lane ends
with the scalar function's result. `time_of_impact` is the plain version
of the time-of-impact kernel (`ops/toi.py`, `csrc/toi.cu`), which runs
the same arithmetic in the same order, one thread per lane.
`test_overlap` is b2TestOverlap, the sensors' touch test, and
`shape_cast` is b2ShapeCast.
"""

from typing import NamedTuple

import torch

from .. import settings
from ..math2d import dot, normalize, rot_t_vec, rot_vec, sweep_get_transform

EPS = 1.1920929e-7

# TOI output states (b2TimeOfImpact.h b2TOIOutput::State)
TOI_UNKNOWN = 0
TOI_FAILED = 1
TOI_OVERLAPPED = 2
TOI_TOUCHING = 3
TOI_SEPARATED = 4

GJK_ITERS = 20          # b2Distance k_maxIters
TOI_ITERS = 20          # b2TimeOfImpact k_maxIterations
PUSH_ITERS = settings.MAX_POLYGON_VERTICES
ROOT_ITERS = 12         # the JAX package's secant/bisection cap


def _take(verts, idx):
    """verts (L, 8, 2), idx (L,) or (L, k) -> (L, 2) or (L, k, 2)."""
    lanes = torch.arange(verts.shape[0], device=verts.device)
    if idx.dim() == 2:
        lanes = lanes[:, None]
    return verts[lanes, idx.long()]


def _count(stats, key, live):
    if stats is not None:
        stats[key] = stats.get(key, 0) + live.to(torch.int32)


def _support(verts, count, d):
    """b2DistanceProxy::GetSupport: index of the vertex most along d."""
    dots = dot(verts, d[:, None, :])
    i8 = torch.arange(verts.shape[1], device=verts.device)
    dots = torch.where(i8 < count[:, None], dots, -3.4e38)
    return torch.argmax(dots, dim=1).to(torch.int32)


class _Simplex(NamedTuple):
    wa: torch.Tensor    # (L, 3, 2) support points on A (world)
    wb: torch.Tensor    # (L, 3, 2)
    ia: torch.Tensor    # (L, 3) i32
    ib: torch.Tensor    # (L, 3) i32
    bary: torch.Tensor  # (L, 3)
    count: torch.Tensor  # (L,) i32


def _where(m, x, y):
    """Per-lane select between two pytrees of (L, ...) tensors."""
    return type(x)(*(torch.where(m.reshape(m.shape + (1,) * (a.dim() - 1)), a, b)
                     for a, b in zip(x, y)))


def _solve2(s: _Simplex) -> _Simplex:
    """b2Simplex::Solve2 (b2Distance.cpp:304-341)."""
    w1 = s.wb[:, 0] - s.wa[:, 0]
    w2 = s.wb[:, 1] - s.wa[:, 1]
    e12 = w2 - w1
    d12_2 = -dot(w1, e12)
    d12_1 = dot(w2, e12)
    # region w1 | region w2 | edge
    in_w1 = d12_2 <= 0.0
    in_w2 = ~in_w1 & (d12_1 <= 0.0)
    vertex = in_w1 | in_w2
    inv = 1.0 / torch.where(d12_1 + d12_2 != 0.0, d12_1 + d12_2, 1.0)
    # the w2 case moves slot 1 to slot 0
    slot0 = torch.where(in_w2, 1, 0)
    i3 = torch.arange(3, device=w1.device)
    first = i3 == 0

    def put0(arr):
        picked = arr[torch.arange(arr.shape[0], device=arr.device), slot0]
        sel = first if arr.dim() == 2 else first[:, None]
        return torch.where(sel, picked[:, None], arr)

    bary = torch.stack([torch.where(vertex, 1.0, d12_1 * inv),
                        torch.where(vertex, 0.0, d12_2 * inv), s.bary[:, 2]], 1)
    return _Simplex(wa=put0(s.wa), wb=put0(s.wb), ia=put0(s.ia), ib=put0(s.ib),
                    bary=bary, count=torch.where(vertex, 1, 2).to(torch.int32))


def _solve3(s: _Simplex) -> _Simplex:
    """b2Simplex::Solve3 (b2Distance.cpp:343-450): 7-region case select."""
    w1 = s.wb[:, 0] - s.wa[:, 0]
    w2 = s.wb[:, 1] - s.wa[:, 1]
    w3 = s.wb[:, 2] - s.wa[:, 2]
    e12 = w2 - w1
    d12_1 = dot(w2, e12)
    d12_2 = -dot(w1, e12)
    e13 = w3 - w1
    d13_1 = dot(w3, e13)
    d13_2 = -dot(w1, e13)
    e23 = w3 - w2
    d23_1 = dot(w3, e23)
    d23_2 = -dot(w2, e23)
    n123 = e12[:, 0] * e13[:, 1] - e12[:, 1] * e13[:, 0]
    d123_1 = n123 * (w2[:, 0] * w3[:, 1] - w2[:, 1] * w3[:, 0])
    d123_2 = n123 * (w3[:, 0] * w1[:, 1] - w3[:, 1] * w1[:, 0])
    d123_3 = n123 * (w1[:, 0] * w2[:, 1] - w1[:, 1] * w2[:, 0])

    c_w1 = (d12_2 <= 0.0) & (d13_2 <= 0.0)
    c_e12 = (d12_1 > 0.0) & (d12_2 > 0.0) & (d123_3 <= 0.0)
    c_e13 = (d13_1 > 0.0) & (d13_2 > 0.0) & (d123_2 <= 0.0)
    c_w2 = (d12_1 <= 0.0) & (d23_2 <= 0.0)
    c_w3 = (d13_1 <= 0.0) & (d23_1 <= 0.0)
    c_e23 = (d23_1 > 0.0) & (d23_2 > 0.0) & (d123_1 <= 0.0)
    # first-match priority (the reference's if-chain order)
    m_w1 = c_w1
    m_e12 = ~m_w1 & c_e12
    m_e13 = ~m_w1 & ~m_e12 & c_e13
    m_w2 = ~m_w1 & ~m_e12 & ~m_e13 & c_w2
    m_w3 = ~m_w1 & ~m_e12 & ~m_e13 & ~m_w2 & c_w3
    m_e23 = ~m_w1 & ~m_e12 & ~m_e13 & ~m_w2 & ~m_w3 & c_e23
    m_tri = ~(m_w1 | m_e12 | m_e13 | m_w2 | m_w3 | m_e23)
    vertex = m_w1 | m_w2 | m_w3

    # slot sources for (slot0, slot1), per case
    # w1: (0,-) e12: (0,1) e13: (0,2) w2: (1,-) w3: (2,-) e23: (1,2) tri: (0,1,2)
    src0 = torch.where(m_w2, 1, torch.where(m_w3, 2, torch.where(m_e23, 1, 0)))
    src1 = torch.where(m_e13 | m_e23, 2, 1)

    def inv(x):
        return 1.0 / torch.where(x != 0.0, x, 1.0)

    inv12 = inv(d12_1 + d12_2)
    inv13 = inv(d13_1 + d13_2)
    inv23 = inv(d23_1 + d23_2)
    inv123 = inv(d123_1 + d123_2 + d123_3)
    w_ = torch.where
    bary0 = w_(vertex, 1.0, w_(m_e12, d12_1 * inv12, w_(m_e13, d13_1 * inv13,
                                                       w_(m_e23, d23_1 * inv23,
                                                          d123_1 * inv123))))
    bary1 = w_(m_e12, d12_2 * inv12, w_(m_e13, d13_2 * inv13,
                                        w_(m_e23, d23_2 * inv23,
                                           w_(m_tri, d123_2 * inv123, 0.0))))
    bary2 = w_(m_tri, d123_3 * inv123, 0.0)
    count = w_(vertex, 1, w_(m_tri, 3, 2)).to(torch.int32)

    def pick(arr):
        lanes = torch.arange(arr.shape[0], device=arr.device)
        return torch.stack([arr[lanes, src0], arr[lanes, src1], arr[:, 2]], 1)

    return _Simplex(wa=pick(s.wa), wb=pick(s.wb), ia=pick(s.ia), ib=pick(s.ib),
                    bary=torch.stack([bary0, bary1, bary2], 1), count=count)


def _gjk_iter(s: _Simplex, verts_a, count_a, pa, qa, verts_b, count_b, pb, qb):
    """One b2Distance iteration on every lane: solve, search direction,
    support points, grow. Returns (simplex, done)."""
    ia_save, ib_save, count_save = s.ia, s.ib, s.count
    s = _where(s.count == 2, _solve2(s), _where(s.count == 3, _solve3(s), s))
    done = s.count == 3

    # search direction (b2Simplex::GetSearchDirection)
    w1 = s.wb[:, 0] - s.wa[:, 0]
    w2 = s.wb[:, 1] - s.wa[:, 1]
    e12 = w2 - w1
    sgn = e12[:, 0] * (-w1[:, 1]) - e12[:, 1] * (-w1[:, 0])
    d2 = torch.where((sgn > 0.0)[:, None],
                     torch.stack([-e12[:, 1], e12[:, 0]], 1),
                     torch.stack([e12[:, 1], -e12[:, 0]], 1))
    d = torch.where((s.count == 1)[:, None], -w1, d2)
    done = done | (dot(d, d) < EPS * EPS)

    ia_new = _support(verts_a, count_a, rot_t_vec(qa, -d))
    ib_new = _support(verts_b, count_b, rot_t_vec(qb, d))
    i3 = torch.arange(3, device=d.device)
    dup = ((i3 < count_save[:, None]) & (ia_save == ia_new[:, None])
           & (ib_save == ib_new[:, None])).any(1)
    done = done | dup

    wa_new = rot_vec(qa, _take(verts_a, ia_new)) + pa
    wb_new = rot_vec(qb, _take(verts_b, ib_new)) + pb
    put = (i3 == s.count.clamp(0, 2)[:, None]) & ~done[:, None]
    s = _Simplex(
        wa=torch.where(put[..., None], wa_new[:, None], s.wa),
        wb=torch.where(put[..., None], wb_new[:, None], s.wb),
        ia=torch.where(put, ia_new[:, None], s.ia),
        ib=torch.where(put, ib_new[:, None], s.ib),
        bary=s.bary, count=torch.where(done, s.count, s.count + 1))
    return s, done


def gjk_distance(verts_a, count_a, radius_a, pa, qa,
                 verts_b, count_b, radius_b, pb, qb, use_radii: bool = False,
                 cache_ia=None, cache_ib=None, cache_count=None, active=None,
                 stats=None, syncs=None):
    """b2Distance over lanes. Returns (point_a, point_b, distance,
    cache_ia (L, 3), cache_ib (L, 3), cache_count) - the cache seeds the
    TOI separation function like b2SimplexCache, and passing a previous
    call's cache warm-starts the simplex (b2Simplex::ReadCache).
    `use_radii` moves the witness points onto the rounded surfaces and
    subtracts the radii from the distance (b2Distance.cpp:585-605; the TOI
    phase runs without).

    Lanes where `active` is False run no iteration; their results are
    meaningless and the caller discards them. The loop's per-trip host
    read goes through `syncs` (an `ops.sync.HostSyncs`) when one is given."""
    n = count_a.shape[0]
    dev = count_a.device
    if cache_ia is not None:
        cia = cache_ia.clamp_min(0)
        cib = cache_ib.clamp_min(0)
        was = rot_vec(qa[:, None], _take(verts_a, cia)) + pa[:, None]
        wbs = rot_vec(qb[:, None], _take(verts_b, cib)) + pb[:, None]
        cnt = cache_count.clamp(1, 3)
        # degenerate 3-simplex guard (the metric check analog of
        # b2Distance.cpp ReadCache): restart from one vertex
        w = wbs - was
        area = ((w[:, 1, 0] - w[:, 0, 0]) * (w[:, 2, 1] - w[:, 0, 1])
                - (w[:, 1, 1] - w[:, 0, 1]) * (w[:, 2, 0] - w[:, 0, 0]))
        cnt = torch.where((cnt == 3) & (area.abs() < EPS), 1, cnt)
        s = _Simplex(wa=was, wb=wbs, ia=cia, ib=cib, bary=None, count=cnt)
    else:
        wa0 = rot_vec(qa, verts_a[:, 0]) + pa
        wb0 = rot_vec(qb, verts_b[:, 0]) + pb
        zi = torch.zeros((n, 3), dtype=torch.int32, device=dev)
        s = _Simplex(wa=wa0[:, None].expand(-1, 3, -1), wb=wb0[:, None].expand(-1, 3, -1),
                     ia=zi, ib=zi, bary=None,
                     count=torch.ones(n, dtype=torch.int32, device=dev))
    bary = torch.zeros((n, 3), device=dev)
    bary[:, 0] = 1.0
    s = s._replace(bary=bary, count=s.count.to(torch.int32))

    done = (torch.zeros(n, dtype=torch.bool, device=dev) if active is None
            else ~active)
    for _ in range(GJK_ITERS):
        live = (~done).any()
        if not (bool(live) if syncs is None else syncs.flag(live)):
            break
        _count(stats, "gjk", ~done)
        s2, done2 = _gjk_iter(s, verts_a, count_a, pa, qa, verts_b, count_b, pb, qb)
        s = _where(done, s, s2)
        done = done | done2

    bw = torch.where(torch.arange(3, device=dev) < s.count[:, None], s.bary, 0.0)
    point_a = (bw[:, 0, None] * s.wa[:, 0] + bw[:, 1, None] * s.wa[:, 1]
               + bw[:, 2, None] * s.wa[:, 2])
    point_b = (bw[:, 0, None] * s.wb[:, 0] + bw[:, 1, None] * s.wb[:, 1]
               + bw[:, 2, None] * s.wb[:, 2])
    point_b = torch.where((s.count == 3)[:, None], point_a, point_b)
    dist = torch.sqrt(dot(point_b - point_a, point_b - point_a))
    if use_radii:
        r_sum = radius_a + radius_b
        separated = ((dist > r_sum) & (dist > EPS))[:, None]
        n, _ = normalize(point_b - point_a)
        mid = 0.5 * (point_a + point_b)
        point_a, point_b = (torch.where(separated, point_a + radius_a[:, None] * n, mid),
                            torch.where(separated, point_b - radius_b[:, None] * n, mid))
        dist = torch.where(separated[:, 0], dist - r_sum, 0.0)
    return point_a, point_b, dist, s.ia, s.ib, s.count


def test_overlap(verts_a, count_a, radius_a, pa, qa,
                 verts_b, count_b, radius_b, pb, qb, syncs=None):
    """b2TestOverlap (b2Collision.cpp:233-252) over lanes: GJK distance
    with the radii below 10 * b2_epsilon; the sensor-touch test
    (b2Contact.cpp:199-205). (L,) bool."""
    _, _, d, _, _, _ = gjk_distance(verts_a, count_a, radius_a, pa, qa,
                                    verts_b, count_b, radius_b, pb, qb,
                                    use_radii=True, syncs=syncs)
    return d < 10.0 * EPS


def shape_cast(verts_a, count_a, radius_a, pa, qa,
               verts_b, count_b, radius_b, pb, qb, translation_b, syncs=None):
    """b2ShapeCast (b2Distance.cpp:608-745) over lanes: conservative
    advancement of proxy B translating by `translation_b` (L, 2) against
    the stationary proxy A.

    Returns (hit (L,) bool, point (L, 2), normal (L, 2), lambda (L,),
    iterations (L,) i32), each lane as the JAX package's branch-free
    scalar loop leaves it: the reference's early returns (a miss, lambda
    past 1, an overlapping simplex) stop a lane through `fail`, and a lane
    whose loop condition fails is frozen. One host read per trip, through
    `syncs` when one is given."""
    n = count_a.shape[0]
    dev = count_a.device
    ra = torch.clamp_min(radius_a, settings.POLYGON_RADIUS)
    rb = torch.clamp_min(radius_b, settings.POLYGON_RADIUS)
    sigma = torch.clamp_min(ra + rb - settings.POLYGON_RADIUS, settings.POLYGON_RADIUS)
    tol = 0.5 * settings.LINEAR_SLOP
    r = translation_b

    def supports(v):
        ia = _support(verts_a, count_a, rot_t_vec(qa, -v))
        ib = _support(verts_b, count_b, rot_t_vec(qb, v))
        return (ia, rot_vec(qa, _take(verts_a, ia)) + pa,
                ib, rot_vec(qb, _take(verts_b, ib)) + pb)

    _, wa0, _, wb0 = supports(r)
    v = wa0 - wb0
    zi = torch.zeros((n, 3), dtype=torch.int32, device=dev)
    bary = torch.zeros((n, 3), device=dev)
    bary[:, 0] = 1.0
    s = _Simplex(wa=torch.zeros((n, 3, 2), device=dev), wb=torch.zeros((n, 3, 2), device=dev),
                 ia=zi, ib=zi, bary=bary, count=torch.zeros(n, dtype=torch.int32, device=dev))
    k = torch.zeros(n, dtype=torch.int32, device=dev)
    normal = torch.zeros((n, 2), device=dev)
    lam = torch.zeros(n, device=dev)
    fail = torch.zeros(n, dtype=torch.bool, device=dev)
    i3 = torch.arange(3, device=dev)
    for _ in range(GJK_ITERS):
        live = (k < GJK_ITERS) & ~fail & ((torch.sqrt(dot(v, v)) - sigma).abs() > tol)
        if not (bool(live.any()) if syncs is None else syncs.flag(live.any())):
            break
        ia, wa, ib, wb = supports(v)
        p = wa - wb
        vu, _ = normalize(v)
        vp = dot(vu, p)
        vr = dot(vu, r)
        advance = vp - sigma > lam * vr
        lam_new = (vp - sigma) / torch.where(vr != 0.0, vr, 1.0)
        fail2 = fail | (advance & ((vr <= 0.0) | (lam_new > 1.0)))
        step = advance & ~fail2
        lam2 = torch.where(step, lam_new, lam)
        normal2 = torch.where(step[:, None], -vu, normal)
        cnt = torch.where(advance, 0, s.count)
        # the simplex is reversed: B - A, with B shifted by lambda * r
        put = i3 == cnt.clamp(0, 2)[:, None]
        s2 = _Simplex(
            wa=torch.where(put[..., None], (wb + lam2[:, None] * r)[:, None], s.wa),
            wb=torch.where(put[..., None], wa[:, None], s.wb),
            ia=torch.where(put, ib[:, None], s.ia), ib=torch.where(put, ia[:, None], s.ib),
            bary=s.bary, count=(cnt + 1).to(torch.int32))
        s2 = _where(s2.count == 2, _solve2(s2), _where(s2.count == 3, _solve3(s2), s2))
        fail2 = fail2 | (s2.count == 3)              # overlap
        bw = torch.where(i3 < s2.count[:, None], s2.bary, 0.0)
        v2 = (bw[..., None] * (s2.wb - s2.wa)).sum(1)
        s = _where(live, s2, s)
        v = torch.where(live[:, None], v2, v)
        normal = torch.where(live[:, None], normal2, normal)
        lam = torch.where(live, lam2, lam)
        fail = torch.where(live, fail2, fail)
        k = k + live.to(torch.int32)

    # the witness point on A: sum(bary * wb slot) (the slots are reversed)
    bw = torch.where(i3 < s.count.clamp_min(1)[:, None], s.bary, 0.0)
    point_a = torch.where((s.count == 0)[:, None], wa0, (bw[..., None] * s.wb).sum(1))
    normal = torch.where((dot(v, v) > 0.0)[:, None], -normalize(v)[0], normal)
    return ~fail, point_a + ra[:, None] * normal, normal, lam, k


# --------------------------------------------------------------------------
# time of impact
# --------------------------------------------------------------------------


class _SepFn(NamedTuple):
    """b2SeparationFunction (b2TimeOfImpact.cpp:35-252), over lanes."""
    ftype: torch.Tensor       # (L,) i32: 0 points / 1 faceA / 2 faceB
    axis: torch.Tensor        # (L, 2)
    local_point: torch.Tensor  # (L, 2)


def _sep_initialize(cache_ia, cache_ib, cache_count, verts_a, verts_b,
                    xfa, xfb) -> _SepFn:
    pa, qa = xfa
    pb, qb = xfb
    one = cache_count == 1
    face_b = ~one & (cache_ia[:, 0] == cache_ia[:, 1])
    wa0 = rot_vec(qa, _take(verts_a, cache_ia[:, 0])) + pa
    wb0 = rot_vec(qb, _take(verts_b, cache_ib[:, 0])) + pb

    # points
    axis_pts, _ = normalize(wb0 - wa0)

    def face(verts, i0, i1, q, p, w_other):
        """Axis and local point of the face (i0, i1) of one proxy, pointing
        at the other proxy's first witness."""
        v1 = _take(verts, i0)
        v2 = _take(verts, i1)
        e = v2 - v1
        ax, _ = normalize(torch.stack([e[:, 1], -e[:, 0]], 1))
        lp = 0.5 * (v1 + v2)
        s = dot(w_other - (rot_vec(q, lp) + p), rot_vec(q, ax))
        return torch.where((s < 0.0)[:, None], -ax, ax), lp

    ax_b, lp_b = face(verts_b, cache_ib[:, 0], cache_ib[:, 1], qb, pb, wa0)
    ax_a, lp_a = face(verts_a, cache_ia[:, 0], cache_ia[:, 1], qa, pa, wb0)
    one2, fb2 = one[:, None], face_b[:, None]
    return _SepFn(
        ftype=torch.where(one, 0, torch.where(face_b, 2, 1)).to(torch.int32),
        axis=torch.where(one2, axis_pts, torch.where(fb2, ax_b, ax_a)),
        local_point=torch.where(one2, 0.0, torch.where(fb2, lp_b, lp_a)))


def _sep_eval(fn: _SepFn, verts_a, verts_b, ia, ib, xfa, xfb):
    """Separation of the witness pair (ia, ib) at the transforms."""
    pa, qa = xfa
    pb, qb = xfb
    wa = rot_vec(qa, _take(verts_a, ia.clamp_min(0))) + pa
    wb = rot_vec(qb, _take(verts_b, ib.clamp_min(0))) + pb
    s_pts = dot(wb - wa, fn.axis)
    s_fa = dot(wb - (rot_vec(qa, fn.local_point) + pa), rot_vec(qa, fn.axis))
    s_fb = dot(wa - (rot_vec(qb, fn.local_point) + pb), rot_vec(qb, fn.axis))
    return torch.where(fn.ftype == 0, s_pts, torch.where(fn.ftype == 1, s_fa, s_fb))


def _sep_min(fn: _SepFn, verts_a, count_a, verts_b, count_b, xfa, xfb):
    """FindMinSeparation: witness indices and separation at the transforms."""
    _, qa = xfa
    _, qb = xfb
    ia_p = _support(verts_a, count_a, rot_t_vec(qa, fn.axis))
    ib_p = _support(verts_b, count_b, rot_t_vec(qb, -fn.axis))
    ib_a = _support(verts_b, count_b, rot_t_vec(qb, -rot_vec(qa, fn.axis)))
    ia_b = _support(verts_a, count_a, rot_t_vec(qa, -rot_vec(qb, fn.axis)))
    ia = torch.where(fn.ftype == 0, ia_p, torch.where(fn.ftype == 1, -1, ia_b))
    ib = torch.where(fn.ftype == 0, ib_p, torch.where(fn.ftype == 1, ib_a, -1))
    return ia, ib, _sep_eval(fn, verts_a, verts_b, ia, ib, xfa, xfb)


def time_of_impact(verts_a, count_a, radius_a, lc_a, c0_a, c_a, a0_a, a_a,
                   verts_b, count_b, radius_b, lc_b, c0_b, c_b, a0_b, a_b,
                   t_max, active=None, stats=None):
    """b2TimeOfImpact (conservative advancement, b2TimeOfImpact.cpp:256-497)
    over lanes with normalized sweeps starting at alpha0 = 0: local centers
    lc (L, 2), sweep centers c0 -> c (L, 2), angles a0 -> a (L,), t_max
    (L,). Lanes where `active` is False return (TOI_UNKNOWN, t_max).
    Returns (state (L,) i32, t (L,)).

    `stats`, a dict, receives each lane's trip counts of the four loops
    (keys gjk, outer, push, root), which a caller can turn into the work
    the lanes needed."""
    n = count_a.shape[0]
    dev = count_a.device
    total_radius = radius_a + radius_b
    target = torch.clamp_min(total_radius - 3.0 * settings.LINEAR_SLOP,
                             settings.LINEAR_SLOP)
    tolerance = 0.25 * settings.LINEAR_SLOP
    hi, lo = target + tolerance, target - tolerance

    def xf_at(t):
        return (sweep_get_transform(lc_a, c0_a, c_a, a0_a, a_a, t),
                sweep_get_transform(lc_b, c0_b, c_b, a0_b, a_b, t))

    def root(fn, wia, wib, a1, a2, s1, s2, rdone):
        """Hybrid secant/bisection for sep(t) == target
        (b2TimeOfImpact.cpp:410-458) on the lanes not in `rdone`."""
        t_root = a2
        for k in range(ROOT_ITERS):
            live = ~rdone
            if not bool(live.any()):
                break
            _count(stats, "root", live)
            if k % 2 == 1:
                t = a1 + (target - s1) * (a2 - a1) / torch.where(s2 != s1, s2 - s1, 1.0)
            else:
                t = 0.5 * (a1 + a2)
            sr = _sep_eval(fn, verts_a, verts_b, wia, wib, *xf_at(t))
            hit = live & ((sr - target).abs() < tolerance)
            t_root = torch.where(hit, t, t_root)
            rdone = rdone | hit
            upd_lo = ~rdone & (sr > target)
            upd_hi = ~rdone & ~(sr > target)
            a1 = torch.where(upd_lo, t, a1)
            s1 = torch.where(upd_lo, sr, s1)
            a2 = torch.where(upd_hi, t, a2)
            s2 = torch.where(upd_hi, sr, s2)
        return t_root

    state = torch.full((n,), TOI_UNKNOWN, dtype=torch.int32, device=dev)
    t_out = t_max.clone()
    t1 = torch.zeros(n, device=dev)
    done = (torch.zeros(n, dtype=torch.bool, device=dev) if active is None
            else ~active)
    cache = (torch.zeros((n, 3), dtype=torch.int32, device=dev),
             torch.zeros((n, 3), dtype=torch.int32, device=dev),
             torch.ones(n, dtype=torch.int32, device=dev))
    for _ in range(TOI_ITERS):
        live = ~done
        if not bool(live.any()):
            break
        _count(stats, "outer", live)
        xfa, xfb = xf_at(t1)
        _, _, dist, cia, cib, ccount = gjk_distance(
            verts_a, count_a, radius_a, xfa[0], xfa[1],
            verts_b, count_b, radius_b, xfb[0], xfb[1],
            cache_ia=cache[0], cache_ib=cache[1], cache_count=cache[2],
            active=live, stats=stats)
        cache = (torch.where(done[:, None], cache[0], cia),
                 torch.where(done[:, None], cache[1], cib),
                 torch.where(done, cache[2], ccount))
        overlapped = live & (dist <= 0.0)
        touching = live & ~overlapped & (dist < hi)
        state = torch.where(overlapped, TOI_OVERLAPPED,
                            torch.where(touching, TOI_TOUCHING, state))
        t_out = torch.where(overlapped, 0.0, torch.where(touching, t1, t_out))
        done_o = done | overlapped | touching
        fn = _sep_initialize(cia, cib, ccount, verts_a, verts_b, xfa, xfb)

        # push-back loop over the deepest points (at most one per vertex)
        t1p, t2 = t1, t_max
        pdone, odone = done_o, torch.zeros_like(done)
        for _ in range(PUSH_ITERS):
            plive = ~pdone
            if not bool(plive.any()):
                break
            _count(stats, "push", plive)
            wia, wib, s2 = _sep_min(fn, verts_a, count_a, verts_b, count_b,
                                    *xf_at(t2))
            separated = plive & (s2 > hi)
            state = torch.where(separated, TOI_SEPARATED, state)
            t_out = torch.where(separated, t_max, t_out)
            advance = plive & ~separated & (s2 > lo)
            t1_next = torch.where(advance, t2, t1p)
            s1 = _sep_eval(fn, verts_a, verts_b, wia, wib, *xf_at(t1p))
            open_ = plive & ~separated & ~advance
            failed = open_ & (s1 < lo)
            touch1 = open_ & ~failed & (s1 <= hi)
            state = torch.where(failed, TOI_FAILED,
                                torch.where(touch1, TOI_TOUCHING, state))
            t_out = torch.where(failed | touch1, t1p, t_out)
            odone = odone | separated | failed | touch1
            pdone = pdone | separated | advance | failed | touch1
            t2 = torch.where(pdone, t2, root(fn, wia, wib, t1p, t2, s1, s2, pdone))
            t1p = t1_next
        t1 = torch.where(done_o, t1, t1p)
        done = done_o | odone
    # root finder stuck -> failed at t1
    state = torch.where(done, state, TOI_FAILED).to(torch.int32)
    return state, torch.where(done, t_out, t1)
