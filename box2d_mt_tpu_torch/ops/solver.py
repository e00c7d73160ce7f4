"""Sequential-impulse contact solver math, batched over worlds.

Port of `box2d_mt_tpu.ops.solver` (reference: b2ContactSolver.cpp):
constraint init with restitution bias (:142-249), warm starting (:253-291),
the friction + 2-point block LCP velocity solve (:293-603) and the NGS
position correction (:676-752). Every formula keeps the JAX package's
order of operations; the colored Gauss-Seidel loops that drive the
per-color math live in `ops/solve_middle.py`.
"""

from typing import NamedTuple

import torch

from .. import settings
from ..math2d import add_at, take

EPS = 1.1920929e-7
_TINY = 1.1754943508222875e-38


class ContactConstraints(NamedTuple):
    """Per-contact solver data (b2ContactVelocityConstraint +
    b2ContactPositionConstraint); leaves (W, C, ...)."""
    active: torch.Tensor        # (W,C) bool
    body_a: torch.Tensor        # (W,C) i32
    body_b: torch.Tensor
    point_count: torch.Tensor   # (W,C) i32 (may drop 2->1 on ill-conditioned K)
    friction: torch.Tensor
    restitution: torch.Tensor
    tangent_speed: torch.Tensor
    inv_mass_a: torch.Tensor
    inv_mass_b: torch.Tensor
    inv_i_a: torch.Tensor
    inv_i_b: torch.Tensor
    normal: torch.Tensor        # (W,C,2)
    r_a: torch.Tensor           # (W,C,2,2) point j anchor rel. center A
    r_b: torch.Tensor           # (W,C,2,2)
    normal_mass: torch.Tensor   # (W,C,2)
    tangent_mass: torch.Tensor  # (W,C,2)
    velocity_bias: torch.Tensor  # (W,C,2)
    k11: torch.Tensor
    k12: torch.Tensor
    k22: torch.Tensor
    nm11: torch.Tensor
    nm12: torch.Tensor
    nm22: torch.Tensor
    local_points: torch.Tensor  # (W,C,2,2)
    local_normal: torch.Tensor  # (W,C,2)
    local_point: torch.Tensor   # (W,C,2)
    radius_a: torch.Tensor
    radius_b: torch.Tensor
    local_center_a: torch.Tensor  # (W,C,2)
    local_center_b: torch.Tensor
    mtype: torch.Tensor         # (W,C) i32


def world_manifold(mtype, local_point, local_normal, points, count,
                   pa, qa, ra, pb, qb, rb):
    """b2WorldManifold::Initialize (b2Collision.cpp): world-space normal
    (..., 2), contact points (..., 2, 2) and separations (..., 2) of a
    batch of manifolds; q is (sin, cos). `count` is unused, as in the
    reference."""
    del count

    def rot(q, v):
        s, c = q[..., 0:1], q[..., 1:2]
        return torch.cat([c * v[..., 0:1] - s * v[..., 1:2],
                          s * v[..., 0:1] + c * v[..., 1:2]], -1)

    def dot(x, y):
        return x[..., 0] * y[..., 0] + x[..., 1] * y[..., 1]

    # circles
    point_a = rot(qa, local_point) + pa
    point_b = rot(qb, points[..., 0, :]) + pb
    d = point_b - point_a
    far = dot(d, d) > EPS * EPS
    ln = torch.sqrt(dot(d, d))
    unit = torch.where((ln < _TINY)[..., None], 0.0,
                       d / torch.where(ln < _TINY, 1.0, ln)[..., None])
    n_c = torch.where(far[..., None], unit,
                      torch.stack([torch.ones_like(ln), torch.zeros_like(ln)], -1))
    ca_c = point_a + ra[..., None] * n_c
    cb_c = point_b - rb[..., None] * n_c
    pts_c = torch.stack([0.5 * (ca_c + cb_c), torch.zeros_like(ca_c)], -2)
    sep_c = torch.stack([dot(cb_c - ca_c, n_c), torch.zeros_like(ra)], -1)

    # faceA
    n_a = rot(qa, local_normal)
    plane_a = rot(qa, local_point) + pa
    clip_a = rot(qb[..., None, :], points) + pb[..., None, :]   # (..., 2, 2)
    ca_a = clip_a + (ra[..., None] - dot(clip_a - plane_a[..., None, :],
                                         n_a[..., None, :]))[..., None] * n_a[..., None, :]
    cb_a = clip_a - rb[..., None, None] * n_a[..., None, :]
    pts_a = 0.5 * (ca_a + cb_a)
    sep_a = dot(cb_a - ca_a, n_a[..., None, :])

    # faceB
    n_b = rot(qb, local_normal)
    plane_b = rot(qb, local_point) + pb
    clip_b = rot(qa[..., None, :], points) + pa[..., None, :]
    cb_b = clip_b + (rb[..., None] - dot(clip_b - plane_b[..., None, :],
                                         n_b[..., None, :]))[..., None] * n_b[..., None, :]
    ca_b = clip_b - ra[..., None, None] * n_b[..., None, :]
    pts_b = 0.5 * (ca_b + cb_b)
    sep_b = dot(ca_b - cb_b, n_b[..., None, :])

    is_a = mtype == settings.MANIFOLD_FACE_A
    is_b = mtype == settings.MANIFOLD_FACE_B
    normal = torch.where(is_a[..., None], n_a,
                         torch.where(is_b[..., None], -n_b, n_c))
    pts = torch.where(is_a[..., None, None], pts_a,
                      torch.where(is_b[..., None, None], pts_b, pts_c))
    seps = torch.where(is_a[..., None], sep_a,
                       torch.where(is_b[..., None], sep_b, sep_c))
    return normal, pts, seps


def init_contact_constraints(contacts, fx, bodies, c_pos, a_pos, v, w,
                             active) -> ContactConstraints:
    """Per-contact constraint data from current positions/velocities
    (b2ContactSolver ctor + InitializeVelocityConstraints)."""
    ia = contacts.f_a.clamp_min(0).long()
    ib = contacts.f_b.clamp_min(0).long()
    ba = take(fx.body, ia).clamp_min(0).long()
    bb = take(fx.body, ib).clamp_min(0).long()

    # default mixing (b2Contact.h:40-50) with per-contact overrides
    friction = torch.sqrt(take(fx.friction, ia) * take(fx.friction, ib))
    friction = torch.where(contacts.friction_override >= 0.0,
                           contacts.friction_override, friction)
    restitution = torch.maximum(take(fx.restitution, ia),
                                take(fx.restitution, ib))
    restitution = torch.where(contacts.restitution_override >= 0.0,
                              contacts.restitution_override, restitution)
    ra_shape = take(fx.radius, ia)
    rb_shape = take(fx.radius, ib)

    m_a, m_b = take(bodies.inv_mass, ba), take(bodies.inv_mass, bb)
    i_a, i_b = take(bodies.inv_inertia, ba), take(bodies.inv_inertia, bb)
    lc_a, lc_b = take(bodies.local_center, ba), take(bodies.local_center, bb)
    ca_pos, cb_pos = take(c_pos, ba), take(c_pos, bb)
    aa_pos, ab_pos = take(a_pos, ba), take(a_pos, bb)
    va, vb = take(v, ba), take(v, bb)
    wa, wb = take(w, ba), take(w, bb)

    cax, cay = ca_pos[..., 0], ca_pos[..., 1]
    cbx, cby = cb_pos[..., 0], cb_pos[..., 1]
    lcax, lcay = lc_a[..., 0], lc_a[..., 1]
    lcbx, lcby = lc_b[..., 0], lc_b[..., 1]
    qas, qac = torch.sin(aa_pos), torch.cos(aa_pos)
    qbs, qbc = torch.sin(ab_pos), torch.cos(ab_pos)
    pax = cax - (qac * lcax - qas * lcay)
    pay = cay - (qas * lcax + qac * lcay)
    pbx = cbx - (qbc * lcbx - qbs * lcby)
    pby = cby - (qbs * lcbx + qbc * lcby)

    lpx = contacts.m_local_point[..., 0]
    lpy = contacts.m_local_point[..., 1]
    lnx = contacts.m_local_normal[..., 0]
    lny = contacts.m_local_normal[..., 1]
    pjx = (contacts.m_points[..., 0, 0], contacts.m_points[..., 1, 0])
    pjy = (contacts.m_points[..., 0, 1], contacts.m_points[..., 1, 1])

    # circles (b2Manifold::e_circles)
    p_ax = pax + (qac * lpx - qas * lpy)
    p_ay = pay + (qas * lpx + qac * lpy)
    p_bx = pbx + (qbc * pjx[0] - qbs * pjy[0])
    p_by = pby + (qbs * pjx[0] + qbc * pjy[0])
    dx_, dy_ = p_bx - p_ax, p_by - p_ay
    dd = dx_ * dx_ + dy_ * dy_
    far = dd > EPS * EPS
    ln_ = torch.sqrt(dd)
    tiny = ln_ < _TINY
    safe = torch.where(tiny, 1.0, ln_)
    ux = torch.where(tiny, 0.0, dx_ / safe)
    uy = torch.where(tiny, 0.0, dy_ / safe)
    ncx = torch.where(far, ux, 1.0)
    ncy = torch.where(far, uy, 0.0)
    ca_cx, ca_cy = p_ax + ra_shape * ncx, p_ay + ra_shape * ncy
    cb_cx, cb_cy = p_bx - rb_shape * ncx, p_by - rb_shape * ncy
    zero = torch.zeros_like(p_ax)
    pts_c = ((0.5 * (ca_cx + cb_cx), 0.5 * (ca_cy + cb_cy)), (zero, zero))

    # faceA
    nax = qac * lnx - qas * lny
    nay = qas * lnx + qac * lny
    planex = pax + (qac * lpx - qas * lpy)
    planey = pay + (qas * lpx + qac * lpy)
    pts_a = []
    for j in range(2):
        clx = pbx + (qbc * pjx[j] - qbs * pjy[j])
        cly = pby + (qbs * pjx[j] + qbc * pjy[j])
        da_ = (clx - planex) * nax + (cly - planey) * nay
        ca_ax = clx + (ra_shape - da_) * nax
        ca_ay = cly + (ra_shape - da_) * nay
        cb_ax = clx - rb_shape * nax
        cb_ay = cly - rb_shape * nay
        pts_a.append((0.5 * (ca_ax + cb_ax), 0.5 * (ca_ay + cb_ay)))

    # faceB (world normal flips at selection)
    nbx = qbc * lnx - qbs * lny
    nby = qbs * lnx + qbc * lny
    planbx = pbx + (qbc * lpx - qbs * lpy)
    planby = pby + (qbs * lpx + qbc * lpy)
    pts_b = []
    for j in range(2):
        clx = pax + (qac * pjx[j] - qas * pjy[j])
        cly = pay + (qas * pjx[j] + qac * pjy[j])
        db_ = (clx - planbx) * nbx + (cly - planby) * nby
        cb_bx = clx + (rb_shape - db_) * nbx
        cb_by = cly + (rb_shape - db_) * nby
        ca_bx = clx - ra_shape * nbx
        ca_by = cly - ra_shape * nby
        pts_b.append((0.5 * (ca_bx + cb_bx), 0.5 * (ca_by + cb_by)))

    is_a = contacts.m_type == settings.MANIFOLD_FACE_A
    is_b = contacts.m_type == settings.MANIFOLD_FACE_B

    def sel(xa, xb, xc):
        return torch.where(is_a, xa, torch.where(is_b, xb, xc))

    nx = sel(nax, -nbx, ncx)
    ny = sel(nay, -nby, ncy)
    ptx = [sel(pts_a[j][0], pts_b[j][0], pts_c[j][0]) for j in range(2)]
    pty = [sel(pts_a[j][1], pts_b[j][1], pts_c[j][1]) for j in range(2)]

    rax = [ptx[j] - cax for j in range(2)]
    ray = [pty[j] - cay for j in range(2)]
    rbx = [ptx[j] - cbx for j in range(2)]
    rby = [pty[j] - cby for j in range(2)]

    msum = m_a + m_b
    rn_a = [rax[j] * ny - ray[j] * nx for j in range(2)]
    rn_b = [rbx[j] * ny - rby[j] * nx for j in range(2)]
    k_n = [msum + i_a * (rn_a[j] * rn_a[j]) + i_b * (rn_b[j] * rn_b[j])
           for j in range(2)]
    nmass = [torch.where(k > 0.0, 1.0 / k, 0.0) for k in k_n]

    tx, ty = ny, -nx
    rt_a = [rax[j] * ty - ray[j] * tx for j in range(2)]
    rt_b = [rbx[j] * ty - rby[j] * tx for j in range(2)]
    k_t = [msum + i_a * (rt_a[j] * rt_a[j]) + i_b * (rt_b[j] * rt_b[j])
           for j in range(2)]
    tmass = [torch.where(k > 0.0, 1.0 / k, 0.0) for k in k_t]

    vax_, vay_ = va[..., 0], va[..., 1]
    vbx_, vby_ = vb[..., 0], vb[..., 1]
    vbias = []
    for j in range(2):
        dvx = vbx_ - wb * rby[j] - vax_ + wa * ray[j]
        dvy = vby_ + wb * rbx[j] - vay_ - wa * rax[j]
        v_rel = dvx * nx + dvy * ny
        vbias.append(torch.where(v_rel < -settings.VELOCITY_THRESHOLD,
                                 -restitution * v_rel, 0.0))

    # 2-point block solver setup with condition-number guard
    point_count = contacts.m_count
    k11 = k_n[0]
    k22 = k_n[1]
    k12 = msum + i_a * rn_a[0] * rn_a[1] + i_b * rn_b[0] * rn_b[1]
    det = k11 * k22 - k12 * k12
    well_conditioned = k11 * k11 < 1000.0 * det
    point_count = torch.where((point_count == 2) & ~well_conditioned, 1,
                              point_count)
    inv_det = torch.where(det != 0.0, 1.0 / det, 0.0)

    def pair(xs):
        return torch.stack(xs, dim=-1)

    return ContactConstraints(
        active=active, body_a=ba.to(torch.int32), body_b=bb.to(torch.int32),
        point_count=point_count.to(torch.int32),
        friction=friction, restitution=restitution,
        tangent_speed=contacts.tangent_speed,
        inv_mass_a=m_a, inv_mass_b=m_b, inv_i_a=i_a, inv_i_b=i_b,
        normal=pair([nx, ny]),
        r_a=torch.stack([pair([rax[0], ray[0]]), pair([rax[1], ray[1]])], -2),
        r_b=torch.stack([pair([rbx[0], rby[0]]), pair([rbx[1], rby[1]])], -2),
        normal_mass=pair(nmass), tangent_mass=pair(tmass),
        velocity_bias=pair(vbias),
        k11=k11, k12=k12, k22=k22,
        nm11=inv_det * k22, nm12=-inv_det * k12, nm22=inv_det * k11,
        local_points=contacts.m_points, local_normal=contacts.m_local_normal,
        local_point=contacts.m_local_point,
        radius_a=ra_shape, radius_b=rb_shape,
        local_center_a=lc_a, local_center_b=lc_b, mtype=contacts.m_type)


def warm_start(cc: ContactConstraints, ni, ti, bst):
    """Apply accumulated impulses (b2ContactSolver::WarmStart). `bst` is
    the plane-major body velocity state (W, 3, N): rows [vx, vy, w]."""
    nx, ny = cc.normal[..., 0], cc.normal[..., 1]
    tangent = torch.stack([ny, -nx], dim=-1)
    pmask = ((torch.arange(2, device=ni.device) < cc.point_count[..., None])
             & cc.active[..., None])                              # (W,C,2)
    p_imp = torch.where(pmask[..., None],
                        ni[..., None] * cc.normal[..., None, :]
                        + ti[..., None] * tangent[..., None, :], 0.0)
    p_sum = p_imp.sum(-2)                                         # (W,C,2)

    def cross(r, p):
        return r[..., 0] * p[..., 1] - r[..., 1] * p[..., 0]

    ang_a = torch.where(pmask, cross(cc.r_a, p_imp), 0.0).sum(-1)
    ang_b = torch.where(pmask, cross(cc.r_b, p_imp), 0.0).sum(-1)
    da = torch.stack([-cc.inv_mass_a * p_sum[..., 0],
                      -cc.inv_mass_a * p_sum[..., 1],
                      -cc.inv_i_a * ang_a], 1)                   # (W,3,C)
    db = torch.stack([cc.inv_mass_b * p_sum[..., 0],
                      cc.inv_mass_b * p_sum[..., 1],
                      cc.inv_i_b * ang_b], 1)
    idx = torch.cat([cc.body_a, cc.body_b], 1).long()
    nw, _, n = bst.shape
    rows = torch.arange(nw * 3, device=idx.device).reshape(nw, 3, 1) * n + idx[:, None, :]
    # a body's deltas in lane order on every device (`add_at`), so two
    # runs, and two equal worlds, agree to the bit
    out = bst.clone(memory_format=torch.contiguous_format)
    add_at(out.view(-1), rows.reshape(-1), torch.cat([da, db], 2).reshape(-1))
    return out


def velocity_contact_math_s(fr, ts, ma, mb, ia_, ib_, nx, ny,
                            rax, ray, rbx, rby,  # (p0, p1) per point j
                            nm, tm, bias, k11, k12, k22, nm11, nm12, nm22,
                            pc, ni, ti, vax, vay, wa, vbx, vby, wb, m):
    """Scalarized SolveVelocityConstraints math (b2ContactSolver.cpp:293-603)
    on component tensors of one shape. Returns (ni, ti, vax..wb)."""
    tx, ty = ny, -nx
    ni = list(ni)
    ti = list(ti)

    # friction, point by point (reference order: j = 0 then 1)
    for j in range(2):
        has = m & (j < pc)
        dvx = vbx - wb * rby[j] - vax + wa * ray[j]
        dvy = vby + wb * rbx[j] - vay - wa * rax[j]
        vt = dvx * tx + dvy * ty - ts
        lam = tm[j] * (-vt)
        max_f = fr * ni[j]
        new_imp = torch.minimum(torch.maximum(ti[j] + lam, -max_f), max_f)
        lam = torch.where(has, new_imp - ti[j], 0.0)
        ti[j] = torch.where(has, new_imp, ti[j])
        px, py = lam * tx, lam * ty
        vax = vax - ma * px
        vay = vay - ma * py
        wa = wa - ia_ * (rax[j] * py - ray[j] * px)
        vbx = vbx + mb * px
        vby = vby + mb * py
        wb = wb + ib_ * (rbx[j] * py - rby[j] * px)

    # normal: 1-point scalar path
    one_pt = m & (pc == 1)
    dvx = vbx - wb * rby[0] - vax + wa * ray[0]
    dvy = vby + wb * rbx[0] - vay - wa * rax[0]
    vn0 = dvx * nx + dvy * ny
    lam0 = -nm[0] * (vn0 - bias[0])
    new0 = torch.clamp_min(ni[0] + lam0, 0.0)
    dlam0 = torch.where(one_pt, new0 - ni[0], 0.0)
    px, py = dlam0 * nx, dlam0 * ny
    vax = vax - ma * px
    vay = vay - ma * py
    wa = wa - ia_ * (rax[0] * py - ray[0] * px)
    vbx = vbx + mb * px
    vby = vby + mb * py
    wb = wb + ib_ * (rbx[0] * py - rby[0] * px)
    ni[0] = torch.where(one_pt, new0, ni[0])

    # normal: 2-point block LCP by total enumeration
    two_pt = m & (pc == 2)
    a1, a2 = ni[0], ni[1]
    dv1x = vbx - wb * rby[0] - vax + wa * ray[0]
    dv1y = vby + wb * rbx[0] - vay - wa * rax[0]
    dv2x = vbx - wb * rby[1] - vax + wa * ray[1]
    dv2y = vby + wb * rbx[1] - vay - wa * rax[1]
    vn1 = dv1x * nx + dv1y * ny
    vn2 = dv2x * nx + dv2y * ny
    b1 = vn1 - bias[0] - (k11 * a1 + k12 * a2)
    b2 = vn2 - bias[1] - (k12 * a1 + k22 * a2)

    x1_1 = -(nm11 * b1 + nm12 * b2)
    x2_1 = -(nm12 * b1 + nm22 * b2)
    ok1 = (x1_1 >= 0.0) & (x2_1 >= 0.0)
    x1_2 = -nm[0] * b1
    vn2_2 = k12 * x1_2 + b2
    ok2 = (x1_2 >= 0.0) & (vn2_2 >= 0.0)
    x2_3 = -nm[1] * b2
    vn1_3 = k12 * x2_3 + b1
    ok3 = (x2_3 >= 0.0) & (vn1_3 >= 0.0)
    ok4 = (b1 >= 0.0) & (b2 >= 0.0)

    w_ = torch.where
    x1 = w_(ok1, x1_1, w_(ok2, x1_2, w_(ok3, 0.0, w_(ok4, 0.0, a1))))
    x2 = w_(ok1, x2_1, w_(ok2, 0.0, w_(ok3, x2_3, w_(ok4, 0.0, a2))))
    # "no solution, give up" keeps the accumulated impulse (d = 0)

    d1 = torch.where(two_pt, x1 - a1, 0.0)
    d2 = torch.where(two_pt, x2 - a2, 0.0)
    p1x, p1y = d1 * nx, d1 * ny
    p2x, p2y = d2 * nx, d2 * ny
    vax = vax - ma * (p1x + p2x)
    vay = vay - ma * (p1y + p2y)
    wa = wa - ia_ * ((rax[0] * p1y - ray[0] * p1x) + (rax[1] * p2y - ray[1] * p2x))
    vbx = vbx + mb * (p1x + p2x)
    vby = vby + mb * (p1y + p2y)
    wb = wb + ib_ * ((rbx[0] * p1y - rby[0] * p1x) + (rbx[1] * p2y - rby[1] * p2x))
    ni[0] = torch.where(two_pt, x1, ni[0])
    ni[1] = torch.where(two_pt, x2, ni[1])
    return tuple(ni), tuple(ti), vax, vay, wa, vbx, vby, wb


def _psm_s(mtype, lpx, lpy, lnx, lny, mpx, mpy,
           pax, pay, qas, qac, ra, pbx, pby, qbs, qbc, rb, j: int):
    """Scalarized b2PositionSolverManifold::Initialize
    (b2ContactSolver.cpp:620-672); j is the static point index."""
    # circles
    p_ax = qac * lpx - qas * lpy + pax
    p_ay = qas * lpx + qac * lpy + pay
    p_bx = qbc * mpx[0] - qbs * mpy[0] + pbx
    p_by = qbs * mpx[0] + qbc * mpy[0] + pby
    dx, dy = p_bx - p_ax, p_by - p_ay
    dist = torch.sqrt(dx * dx + dy * dy)
    pos = dist > 0.0
    safe = torch.where(pos, dist, 1.0)
    ncx = torch.where(pos, dx / safe, 0.0)
    ncy = torch.where(pos, dy / safe, 0.0)
    ptcx, ptcy = 0.5 * (p_ax + p_bx), 0.5 * (p_ay + p_by)
    sep_c = dx * ncx + dy * ncy - ra - rb

    clx, cly = mpx[j], mpy[j]
    # faceA
    nax = qac * lnx - qas * lny
    nay = qas * lnx + qac * lny
    cax = qbc * clx - qbs * cly + pbx
    cay = qbs * clx + qbc * cly + pby
    sep_a = (cax - p_ax) * nax + (cay - p_ay) * nay - ra - rb
    # faceB
    nbx = qbc * lnx - qbs * lny
    nby = qbs * lnx + qbc * lny
    plane_bx = qbc * lpx - qbs * lpy + pbx
    plane_by = qbs * lpx + qbc * lpy + pby
    cbx = qac * clx - qas * cly + pax
    cby = qas * clx + qac * cly + pay
    sep_b = (cbx - plane_bx) * nbx + (cby - plane_by) * nby - ra - rb

    is_a = mtype == settings.MANIFOLD_FACE_A
    is_b = mtype == settings.MANIFOLD_FACE_B

    def sel(xa, xb, xc):
        return torch.where(is_a, xa, torch.where(is_b, xb, xc))

    return (sel(nax, -nbx, ncx), sel(nay, -nby, ncy), sel(cax, cbx, ptcx),
            sel(cay, cby, ptcy), sel(sep_a, sep_b, sep_c))


def position_contact_math_s(mtype, pc, ma, mb, ia_, ib_, ra, rb,
                            lcax, lcay, lcbx, lcby, lpx, lpy, lnx, lny,
                            mpx, mpy, cax, cay, aa, cbx, cby, ab, m,
                            baumgarte, max_correction):
    """Scalarized NGS position pass over both manifold points. Returns the
    moved (cax..ab) and min(0, separation) over the points."""
    min_sep = torch.zeros_like(aa)
    for j in range(2):
        has = m & (j < pc)
        qas, qac = torch.sin(aa), torch.cos(aa)
        qbs, qbc = torch.sin(ab), torch.cos(ab)
        pax = cax - (qac * lcax - qas * lcay)
        pay = cay - (qas * lcax + qac * lcay)
        pbx = cbx - (qbc * lcbx - qbs * lcby)
        pby = cby - (qbs * lcbx + qbc * lcby)
        nx, ny, px, py, sep = _psm_s(
            mtype, lpx, lpy, lnx, lny, mpx, mpy,
            pax, pay, qas, qac, ra, pbx, pby, qbs, qbc, rb, j)
        r_ax, r_ay = px - cax, py - cay
        r_bx, r_by = px - cbx, py - cby
        min_sep = torch.where(has, torch.minimum(min_sep, sep), min_sep)
        corr = torch.clamp(baumgarte * (sep + settings.LINEAR_SLOP),
                           -max_correction, 0.0)
        rn_a = r_ax * ny - r_ay * nx
        rn_b = r_bx * ny - r_by * nx
        k = ma + mb + ia_ * rn_a * rn_a + ib_ * rn_b * rn_b
        kpos = k > 0.0
        impulse = torch.where(has & kpos, -corr / torch.where(kpos, k, 1.0), 0.0)
        ix, iy = impulse * nx, impulse * ny
        cax = cax - ma * ix
        cay = cay - ma * iy
        aa = aa - ia_ * (r_ax * iy - r_ay * ix)
        cbx = cbx + mb * ix
        cby = cby + mb * iy
        ab = ab + ib_ * (r_bx * iy - r_by * ix)
    return cax, cay, aa, cbx, cby, ab, min_sep


CC_BLOB_K = 51


def pack_cc_blob_t(cc: ContactConstraints, ni, ti):
    """Plane-major (W, 51, C) constraint rows in SLOT order — the layout
    of the JAX package's `pack_cc_blob_t` (row k holds field k across the
    contact lanes); the solve middle reads its rows by these numbers."""
    f = lambda x: x.to(torch.float32)
    rows = [f(cc.active), f(cc.body_a), f(cc.body_b), f(cc.point_count),
            cc.friction, cc.tangent_speed,
            cc.inv_mass_a, cc.inv_mass_b, cc.inv_i_a, cc.inv_i_b,
            cc.normal[..., 0], cc.normal[..., 1],
            cc.r_a[..., 0, 0], cc.r_a[..., 0, 1],
            cc.r_a[..., 1, 0], cc.r_a[..., 1, 1],
            cc.r_b[..., 0, 0], cc.r_b[..., 0, 1],
            cc.r_b[..., 1, 0], cc.r_b[..., 1, 1],
            cc.normal_mass[..., 0], cc.normal_mass[..., 1],
            cc.tangent_mass[..., 0], cc.tangent_mass[..., 1],
            cc.velocity_bias[..., 0], cc.velocity_bias[..., 1],
            cc.k11, cc.k12, cc.k22, cc.nm11, cc.nm12, cc.nm22,
            cc.local_points[..., 0, 0], cc.local_points[..., 0, 1],
            cc.local_points[..., 1, 0], cc.local_points[..., 1, 1],
            cc.local_normal[..., 0], cc.local_normal[..., 1],
            cc.local_point[..., 0], cc.local_point[..., 1],
            cc.radius_a, cc.radius_b,
            cc.local_center_a[..., 0], cc.local_center_a[..., 1],
            cc.local_center_b[..., 0], cc.local_center_b[..., 1],
            f(cc.mtype), ni[..., 0], ni[..., 1], ti[..., 0], ti[..., 1]]
    assert len(rows) == CC_BLOB_K
    return torch.stack(rows, dim=1).contiguous()
