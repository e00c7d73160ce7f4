"""Batched joint constraint solvers.

Port of `box2d_mt_tpu.joints.solver` for all eleven joint types
(reference: Box2D/Dynamics/Joints/b2*Joint.cpp), written over a leading
world axis where the JAX package vmaps a per-world function: blocks and
per-joint data are (W, J...), body state is v (W, N, 2), w (W, N), c (W,
N, 2), a (W, N). Every expression keeps the JAX package's order of
floating-point operations.

All types but the gear share one coloring pass (joints conflict through
shared dynamic bodies exactly like contacts); within a color every type's
masked pass adds its deltas to disjoint dynamic bodies. Static endpoints
are shared, and receive exact zeros from every lane, so the deltas are
summed into zeros and then added (`math2d.add_rows`), never assigned
through an index.

Limit states (e_inactiveLimit/e_atLower/e_atUpper/e_equalLimits,
b2Joint.h:77-84) persist across steps in the joint block and gate impulse
resets at init, matching the reference's hysteresis.

The color passes loop over the colors in use, and each type's pass runs
only for the colors its joints use (one host read in `init_joints`),
where the JAX package runs every type's masked pass for each of
`max_colors` colors: a pass that masks out every lane changes nothing.
"""

import dataclasses
import math
from typing import NamedTuple

import torch

from .. import settings
from ..math2d import (add_rows, cross_sv, cross_vv, dot, rot_from_angle, rot_t_vec,
                      rot_vec, take)
from ..ops import coloring
from ..ops.sync import HostSyncs

# limit states (b2Joint.h:77-84)
LIMIT_INACTIVE = 0
LIMIT_AT_LOWER = 1
LIMIT_AT_UPPER = 2
LIMIT_EQUAL = 3


def _inv(x, cond):
    """1 / x where `cond`, else 0 (no division by zero is evaluated)."""
    return torch.where(cond, 1.0 / torch.where(cond, x, 1.0), 0.0)


def _solve22(k11, k12, k22, bx, by):
    det = k11 * k22 - k12 * k12
    inv = _inv(det, det != 0.0)
    return inv * (k22 * bx - k12 * by), inv * (k11 * by - k12 * bx)


def _solve33(k11, k12, k13, k22, k23, k33, bx, by, bz):
    """b2Mat33::Solve33 (b2Math.cpp): Cramer with zero-det guard."""
    cx = k22 * k33 - k23 * k23
    cy = k23 * k13 - k12 * k33
    cz = k12 * k23 - k22 * k13
    det = k11 * cx + k12 * cy + k13 * cz
    inv = _inv(det, det != 0.0)
    x = inv * (bx * cx + by * cy + bz * cz)
    y = inv * (bx * cy
               + by * (k11 * k33 - k13 * k13)
               + bz * (k13 * k12 - k11 * k23))
    z = inv * (bx * cz
               + by * (k13 * k12 - k11 * k23)
               + bz * (k11 * k22 - k12 * k12))
    return x, y, z


def _clip(x, lo, hi):
    """jnp.clip: min(max(x, lo), hi) with scalar or tensor bounds."""
    if not torch.is_tensor(lo):
        lo = torch.full_like(x, lo)
    if not torch.is_tensor(hi):
        hi = torch.full_like(x, hi)
    return torch.minimum(torch.maximum(x, lo), hi)


class _Common(NamedTuple):
    active: torch.Tensor
    body_a: torch.Tensor
    body_b: torch.Tensor
    m_a: torch.Tensor
    m_b: torch.Tensor
    i_a: torch.Tensor
    i_b: torch.Tensor
    lc_a: torch.Tensor
    lc_b: torch.Tensor
    color: torch.Tensor


def _common(block, bodies, awake, color):
    ba = block.body_a.clamp_min(0).long()
    bb = block.body_b.clamp_min(0).long()
    dyn = bodies.is_dynamic
    # a joint is solved only while a dynamic endpoint is awake
    active = block.active & ((take(dyn, ba) & take(awake, ba))
                             | (take(dyn, bb) & take(awake, bb)))
    return _Common(
        active=active, body_a=ba, body_b=bb,
        m_a=take(bodies.inv_mass, ba), m_b=take(bodies.inv_mass, bb),
        i_a=take(bodies.inv_inertia, ba), i_b=take(bodies.inv_inertia, bb),
        lc_a=take(bodies.local_center, ba), lc_b=take(bodies.local_center, bb),
        color=color)


def _scatter(com, lin, ang, m, d_la, d_aa, d_lb, d_ab):
    """(lin (W, N, 2), ang (W, N)) plus the lanes' deltas at both
    endpoints, zero where `m` is off."""
    m2 = m[..., None]
    d_a = torch.cat([torch.where(m2, d_la, 0.0),
                     torch.where(m, d_aa, 0.0)[..., None]], -1)
    d_b = torch.cat([torch.where(m2, d_lb, 0.0),
                     torch.where(m, d_ab, 0.0)[..., None]], -1)
    out = add_rows(torch.cat([lin, ang[..., None]], -1),
                   torch.cat([com.body_a, com.body_b], 1),
                   torch.cat([d_a, d_b], 1))
    return out[..., 0:2], out[..., 2]


def _apply(com, v, w, mask, d_va, d_wa, d_vb, d_wb):
    return _scatter(com, v, w, mask & com.active, d_va, d_wa, d_vb, d_wb)


def _all_lanes(com):
    return torch.ones_like(com.active)


# ==========================================================================
# revolute (b2RevoluteJoint.cpp)
# ==========================================================================


class RevoluteData(NamedTuple):
    com: _Common
    r_a: torch.Tensor      # (W,J,2)
    r_b: torch.Tensor
    k11: torch.Tensor
    k12: torch.Tensor
    k13: torch.Tensor
    k22: torch.Tensor
    k23: torch.Tensor
    k33: torch.Tensor
    motor_mass: torch.Tensor
    fixed_rotation: torch.Tensor


def _point_mass(r_a, r_b, mA, mB, iA, iB):
    """The point-to-point K matrix entries shared by revolute and weld."""
    k11 = mA + mB + r_a[..., 1] ** 2 * iA + r_b[..., 1] ** 2 * iB
    k12 = -r_a[..., 1] * r_a[..., 0] * iA - r_b[..., 1] * r_b[..., 0] * iB
    k13 = -r_a[..., 1] * iA - r_b[..., 1] * iB
    k22 = mA + mB + r_a[..., 0] ** 2 * iA + r_b[..., 0] ** 2 * iB
    k23 = r_a[..., 0] * iA + r_b[..., 0] * iB
    k33 = iA + iB
    return k11, k12, k13, k22, k23, k33


def _anchors(blk, com, a_a, a_b):
    qa = rot_from_angle(a_a)
    qb = rot_from_angle(a_b)
    return (qa, rot_vec(qa, blk.local_anchor_a - com.lc_a),
            rot_vec(qb, blk.local_anchor_b - com.lc_b))


def _warm_scaled(x, dt_ratio, warm):
    if not warm:
        return torch.zeros_like(x)
    return x * dt_ratio.reshape((-1,) + (1,) * (x.dim() - 1))


def _with_z(imp, z):
    return torch.cat([imp[..., 0:2], z[..., None]], -1)


def _revolute_init(blk, bodies, awake, color, dt_ratio, warm):
    com = _common(blk, bodies, awake, color)
    a_a, a_b = take(bodies.a, com.body_a), take(bodies.a, com.body_b)
    _, r_a, r_b = _anchors(blk, com, a_a, a_b)
    mA, mB, iA, iB = com.m_a, com.m_b, com.i_a, com.i_b
    fixed = (iA + iB) == 0.0
    k11, k12, k13, k22, k23, k33 = _point_mass(r_a, r_b, mA, mB, iA, iB)
    motor_mass = _inv(k33, k33 > 0.0)

    # limit state transition (InitVelocityConstraints)
    angle = a_b - a_a - blk.reference_angle
    equal = torch.abs(blk.upper_angle - blk.lower_angle) < 2.0 * settings.ANGULAR_SLOP
    at_lower = angle <= blk.lower_angle
    at_upper = angle >= blk.upper_angle
    inactive = torch.full_like(blk.limit_state, LIMIT_INACTIVE)
    new_state = torch.where(
        blk.enable_limit & ~fixed,
        torch.where(equal, LIMIT_EQUAL,
                    torch.where(at_lower, LIMIT_AT_LOWER,
                                torch.where(at_upper, LIMIT_AT_UPPER, inactive))),
        inactive).to(torch.int32)
    z_reset = (((new_state == LIMIT_AT_LOWER) & (blk.limit_state != LIMIT_AT_LOWER))
               | ((new_state == LIMIT_AT_UPPER) & (blk.limit_state != LIMIT_AT_UPPER))
               | (new_state == LIMIT_INACTIVE))

    imp = _warm_scaled(blk.impulse, dt_ratio, warm)
    mot = _warm_scaled(blk.motor_impulse, dt_ratio, warm)
    imp = _with_z(imp, torch.where(z_reset, 0.0, imp[..., 2]))
    mot = torch.where(~blk.enable_motor | fixed, 0.0, mot)

    data = RevoluteData(com, r_a, r_b, k11, k12, k13, k22, k23, k33,
                        motor_mass, fixed)
    return data, {"impulse": imp, "motor_impulse": mot, "limit_state": new_state}


def _revolute_warm(data, st, v, w):
    com = data.com
    imp = st["impulse"]
    p = imp[..., :2]
    l_a = cross_vv(data.r_a, p) + st["motor_impulse"] + imp[..., 2]
    l_b = cross_vv(data.r_b, p) + st["motor_impulse"] + imp[..., 2]
    return _apply(com, v, w, _all_lanes(com),
                  -com.m_a[..., None] * p, -com.i_a * l_a,
                  com.m_b[..., None] * p, com.i_b * l_b)


def _revolute_velocity(blk, data, st, v, w, dt, mask):
    com = data.com
    m = mask & com.active
    va0, wa0 = take(v, com.body_a), take(w, com.body_a)
    vb0, wb0 = take(v, com.body_b), take(w, com.body_b)
    va, wa, vb, wb = va0, wa0, vb0, wb0
    iA, iB, mA, mB = com.i_a, com.i_b, com.m_a, com.m_b
    limit_state = st["limit_state"]
    imp = st["impulse"]
    fixed = data.fixed_rotation

    # motor
    motor_on = blk.enable_motor & (limit_state != LIMIT_EQUAL) & ~fixed & m
    cdot_m = wb - wa - blk.motor_speed
    lam = -data.motor_mass * cdot_m
    max_imp = dt * blk.max_motor_torque
    new_mi = _clip(st["motor_impulse"] + lam, -max_imp, max_imp)
    dlam = torch.where(motor_on, new_mi - st["motor_impulse"], 0.0)
    motor_impulse = torch.where(motor_on, new_mi, st["motor_impulse"])
    wa = wa - iA * dlam
    wb = wb + iB * dlam

    # limit branch (3x3 block)
    limit_on = blk.enable_limit & (limit_state != LIMIT_INACTIVE) & ~fixed & m
    cdot1 = vb + cross_sv(wb, data.r_b) - va - cross_sv(wa, data.r_a)
    cdot2 = wb - wa
    ix, iy, iz = _solve33(data.k11, data.k12, data.k13, data.k22, data.k23,
                          data.k33, -cdot1[..., 0], -cdot1[..., 1], -cdot2)
    new_z = imp[..., 2] + iz
    # limit clamp: if the accumulated z would change sign, re-solve 2x2
    viol = (((limit_state == LIMIT_AT_LOWER) & (new_z < 0.0))
            | ((limit_state == LIMIT_AT_UPPER) & (new_z > 0.0)))
    rhs_x = -cdot1[..., 0] + imp[..., 2] * data.k13
    rhs_y = -cdot1[..., 1] + imp[..., 2] * data.k23
    red_x, red_y = _solve22(data.k11, data.k12, data.k22, rhs_x, rhs_y)
    dx = torch.where(viol, red_x, ix)
    dy = torch.where(viol, red_y, iy)
    dz = torch.where(viol, -imp[..., 2], iz)
    imp_l = torch.stack([imp[..., 0] + dx, imp[..., 1] + dy,
                         torch.where(viol, 0.0, imp[..., 2] + dz)], -1)

    # point-to-point branch (2x2)
    px, py = _solve22(data.k11, data.k12, data.k22, -cdot1[..., 0], -cdot1[..., 1])
    imp_p = torch.stack([imp[..., 0] + px, imp[..., 1] + py, imp[..., 2]], -1)

    d_imp_x = torch.where(limit_on, dx, px)
    d_imp_y = torch.where(limit_on, dy, py)
    d_imp_z = torch.where(limit_on, dz, 0.0)
    imp_new = torch.where(limit_on[..., None], imp_l, imp_p)
    imp_new = torch.where(m[..., None], imp_new, imp)

    p = torch.stack([d_imp_x, d_imp_y], -1)
    p = torch.where(m[..., None], p, 0.0)
    d_imp_z = torch.where(m, d_imp_z, 0.0)
    va = va - mA[..., None] * p
    wa = wa - iA * (cross_vv(data.r_a, p) + d_imp_z)
    vb = vb + mB[..., None] * p
    wb = wb + iB * (cross_vv(data.r_b, p) + d_imp_z)

    st = {**st, "impulse": imp_new, "motor_impulse": motor_impulse}
    v, w = _apply(com, v, w, mask, va - va0, wa - wa0, vb - vb0, wb - wb0)
    return st, v, w


def _revolute_position(blk, data, st, c, a, mask):
    com = data.com
    m = mask & com.active
    ca0, aa0 = take(c, com.body_a), take(a, com.body_a)
    cb0, ab0 = take(c, com.body_b), take(a, com.body_b)
    ca, aa, cb, ab = ca0, aa0, cb0, ab0
    iA, iB, mA, mB = com.i_a, com.i_b, com.m_a, com.m_b
    fixed = data.fixed_rotation
    limit_state = st["limit_state"]

    limit_on = blk.enable_limit & (limit_state != LIMIT_INACTIVE) & ~fixed & m
    angle = ab - aa - blk.reference_angle
    mac = settings.MAX_ANGULAR_CORRECTION
    c_eq = _clip(angle - blk.lower_angle, -mac, mac)
    c_lo_raw = angle - blk.lower_angle
    c_lo = _clip(c_lo_raw + settings.ANGULAR_SLOP, -mac, 0.0)
    c_up_raw = angle - blk.upper_angle
    c_up = _clip(c_up_raw - settings.ANGULAR_SLOP, 0.0, mac)
    zero = torch.zeros_like(angle)
    c_limit = torch.where(limit_state == LIMIT_EQUAL, c_eq,
                          torch.where(limit_state == LIMIT_AT_LOWER, c_lo,
                                      torch.where(limit_state == LIMIT_AT_UPPER, c_up, zero)))
    err = torch.where(limit_state == LIMIT_EQUAL, torch.abs(c_eq),
                      torch.where(limit_state == LIMIT_AT_LOWER, -c_lo_raw,
                                  torch.where(limit_state == LIMIT_AT_UPPER, c_up_raw, zero)))
    limit_impulse = torch.where(limit_on, -data.motor_mass * c_limit, 0.0)
    angular_error = torch.where(limit_on, err, 0.0)
    aa = aa - iA * limit_impulse
    ab = ab + iB * limit_impulse

    # point-to-point
    _, r_a, r_b = _anchors(blk, com, aa, ab)
    cvec = cb + r_b - ca - r_a
    position_error = torch.sqrt(dot(cvec, cvec))
    k11 = mA + mB + iA * r_a[..., 1] ** 2 + iB * r_b[..., 1] ** 2
    k12 = -iA * r_a[..., 0] * r_a[..., 1] - iB * r_b[..., 0] * r_b[..., 1]
    k22 = mA + mB + iA * r_a[..., 0] ** 2 + iB * r_b[..., 0] ** 2
    px, py = _solve22(k11, k12, k22, -cvec[..., 0], -cvec[..., 1])
    p = torch.stack([px, py], -1)
    p = torch.where(m[..., None], p, 0.0)
    ca = ca - mA[..., None] * p
    aa = aa - iA * cross_vv(r_a, p)
    cb = cb + mB[..., None] * p
    ab = ab + iB * cross_vv(r_b, p)

    ok = ((position_error <= settings.LINEAR_SLOP)
          & (angular_error <= settings.ANGULAR_SLOP)) | ~m
    c, a = _scatter(com, c, a, m, ca - ca0, aa - aa0, cb - cb0, ab - ab0)
    return c, a, ok


# ==========================================================================
# distance (b2DistanceJoint.cpp)
# ==========================================================================


class DistanceData(NamedTuple):
    com: _Common
    r_a: torch.Tensor
    r_b: torch.Tensor
    u: torch.Tensor        # (W,J,2) unit axis
    mass: torch.Tensor
    gamma: torch.Tensor
    bias: torch.Tensor
    soft: torch.Tensor     # bool frequency > 0


def _spring(mass, frequency, damping_ratio, cc, dt):
    """Soft-constraint gamma and bias (b2DistanceJoint.cpp:98-117)."""
    omega = 2.0 * math.pi * frequency
    d = 2.0 * mass * damping_ratio * omega
    k = mass * omega * omega
    gamma_raw = dt * (d + dt * k)
    gamma = _inv(gamma_raw, gamma_raw != 0.0)
    return gamma, cc * dt * k * gamma


def _distance_init(blk, bodies, awake, color, dt_ratio, warm, dt):
    com = _common(blk, bodies, awake, color)
    _, r_a, r_b = _anchors(blk, com, take(bodies.a, com.body_a),
                           take(bodies.a, com.body_b))
    u = take(bodies.c, com.body_b) + r_b - take(bodies.c, com.body_a) - r_a
    length = torch.sqrt(dot(u, u))
    u = torch.where((length > settings.LINEAR_SLOP)[..., None],
                    u / torch.where(length > 0, length, 1.0)[..., None], 0.0)
    cr_a = cross_vv(r_a, u)
    cr_b = cross_vv(r_b, u)
    inv_mass = com.m_a + com.i_a * cr_a ** 2 + com.m_b + com.i_b * cr_b ** 2
    mass = _inv(inv_mass, inv_mass != 0.0)

    soft = blk.frequency > 0.0
    gamma, bias = _spring(mass, blk.frequency, blk.damping_ratio,
                          length - blk.length, dt)
    inv_mass_soft = inv_mass + gamma
    mass = torch.where(soft, _inv(inv_mass_soft, inv_mass_soft != 0.0), mass)
    gamma = torch.where(soft, gamma, 0.0)
    bias = torch.where(soft, bias, 0.0)

    imp = _warm_scaled(blk.impulse, dt_ratio, warm)
    return DistanceData(com, r_a, r_b, u, mass, gamma, bias, soft), {"impulse": imp}


def _distance_impulse(com, data, v, w, mask, p):
    return _apply(com, v, w, mask,
                  -com.m_a[..., None] * p, -com.i_a * cross_vv(data.r_a, p),
                  com.m_b[..., None] * p, com.i_b * cross_vv(data.r_b, p))


def _distance_warm(data, st, v, w):
    com = data.com
    return _distance_impulse(com, data, v, w, _all_lanes(com),
                             st["impulse"][..., None] * data.u)


def _distance_velocity(blk, data, st, v, w, dt, mask):
    com = data.com
    m = mask & com.active
    vp_a = take(v, com.body_a) + cross_sv(take(w, com.body_a), data.r_a)
    vp_b = take(v, com.body_b) + cross_sv(take(w, com.body_b), data.r_b)
    cdot = dot(data.u, vp_b - vp_a)
    lam = -data.mass * (cdot + data.bias + data.gamma * st["impulse"])
    lam = torch.where(m, lam, 0.0)
    v, w = _distance_impulse(com, data, v, w, mask, lam[..., None] * data.u)
    return {**st, "impulse": st["impulse"] + lam}, v, w


def _distance_position(blk, data, st, c, a, mask):
    com = data.com
    m = mask & com.active & ~data.soft
    _, r_a, r_b = _anchors(blk, com, take(a, com.body_a), take(a, com.body_b))
    u = take(c, com.body_b) + r_b - take(c, com.body_a) - r_a
    length = torch.sqrt(dot(u, u))
    u = u / torch.where(length > 0, length, 1.0)[..., None]
    cc = _clip(length - blk.length, -settings.MAX_LINEAR_CORRECTION,
               settings.MAX_LINEAR_CORRECTION)
    lam = torch.where(m, -data.mass * cc, 0.0)
    p = lam[..., None] * u
    c, a = _scatter(com, c, a, m,
                    -com.m_a[..., None] * p, -com.i_a * cross_vv(r_a, p),
                    com.m_b[..., None] * p, com.i_b * cross_vv(r_b, p))
    ok = (torch.abs(cc) < settings.LINEAR_SLOP) | ~m
    return c, a, ok


# ==========================================================================
# prismatic (b2PrismaticJoint.cpp)
# ==========================================================================


class PrismaticData(NamedTuple):
    com: _Common
    axis: torch.Tensor
    perp: torch.Tensor
    a1: torch.Tensor
    a2: torch.Tensor
    s1: torch.Tensor
    s2: torch.Tensor
    k11: torch.Tensor
    k12: torch.Tensor
    k13: torch.Tensor
    k22: torch.Tensor
    k23: torch.Tensor
    k33: torch.Tensor
    motor_mass: torch.Tensor


def _prismatic_frame(blk, com, qa, r_a, r_b, d):
    """Axis, perpendicular and their lever arms for the anchor offset `d`,
    and the K matrix entries (b2PrismaticJoint.cpp:135-175)."""
    mA, mB, iA, iB = com.m_a, com.m_b, com.i_a, com.i_b
    axis = rot_vec(qa, blk.local_axis_a)
    a1 = cross_vv(d + r_a, axis)
    a2 = cross_vv(r_b, axis)
    local_y = torch.stack([-blk.local_axis_a[..., 1], blk.local_axis_a[..., 0]], -1)
    perp = rot_vec(qa, local_y)
    s1 = cross_vv(d + r_a, perp)
    s2 = cross_vv(r_b, perp)
    k11 = mA + mB + iA * s1 * s1 + iB * s2 * s2
    k12 = iA * s1 + iB * s2
    k13 = iA * s1 * a1 + iB * s2 * a2
    k22_raw = iA + iB
    k22 = torch.where(k22_raw == 0.0, 1.0, k22_raw)
    k23 = iA * a1 + iB * a2
    k33 = mA + mB + iA * a1 * a1 + iB * a2 * a2
    return axis, perp, a1, a2, s1, s2, (k11, k12, k13, k22, k23, k33)


def _prismatic_init(blk, bodies, awake, color, dt_ratio, warm):
    com = _common(blk, bodies, awake, color)
    qa, r_a, r_b = _anchors(blk, com, take(bodies.a, com.body_a),
                            take(bodies.a, com.body_b))
    d = take(bodies.c, com.body_b) - take(bodies.c, com.body_a) + r_b - r_a
    axis, perp, a1, a2, s1, s2, kk = _prismatic_frame(blk, com, qa, r_a, r_b, d)
    k_m = com.m_a + com.m_b + com.i_a * a1 * a1 + com.i_b * a2 * a2
    motor_mass = _inv(k_m, k_m > 0.0)

    # limit state
    translation = dot(axis, d)
    equal = (torch.abs(blk.upper_translation - blk.lower_translation)
             < 2.0 * settings.LINEAR_SLOP)
    at_lower = translation <= blk.lower_translation
    at_upper = translation >= blk.upper_translation
    inactive = torch.full_like(blk.limit_state, LIMIT_INACTIVE)
    new_state = torch.where(
        blk.enable_limit,
        torch.where(equal, LIMIT_EQUAL,
                    torch.where(at_lower, LIMIT_AT_LOWER,
                                torch.where(at_upper, LIMIT_AT_UPPER, inactive))),
        inactive).to(torch.int32)
    # z survives only while the lower/upper state persists, or at equal limits
    keep = (((new_state == blk.limit_state) & (new_state != LIMIT_INACTIVE))
            | (new_state == LIMIT_EQUAL))
    imp = _warm_scaled(blk.impulse, dt_ratio, warm)
    imp = _with_z(imp, torch.where(keep, imp[..., 2], 0.0))
    mot = _warm_scaled(blk.motor_impulse, dt_ratio, warm)
    mot = torch.where(~blk.enable_motor, 0.0, mot)

    data = PrismaticData(com, axis, perp, a1, a2, s1, s2, *kk, motor_mass)
    return data, {"impulse": imp, "motor_impulse": mot, "limit_state": new_state}


def _prismatic_warm(data, st, v, w):
    com = data.com
    imp = st["impulse"]
    mi = st["motor_impulse"]
    p = imp[..., 0:1] * data.perp + (mi + imp[..., 2])[..., None] * data.axis
    l_a = imp[..., 0] * data.s1 + imp[..., 1] + (mi + imp[..., 2]) * data.a1
    l_b = imp[..., 0] * data.s2 + imp[..., 1] + (mi + imp[..., 2]) * data.a2
    return _apply(com, v, w, _all_lanes(com),
                  -com.m_a[..., None] * p, -com.i_a * l_a,
                  com.m_b[..., None] * p, com.i_b * l_b)


def _prismatic_velocity(blk, data, st, v, w, dt, mask):
    com = data.com
    m = mask & com.active
    va0, wa0 = take(v, com.body_a), take(w, com.body_a)
    vb0, wb0 = take(v, com.body_b), take(w, com.body_b)
    va, wa, vb, wb = va0, wa0, vb0, wb0
    mA, mB, iA, iB = com.m_a, com.m_b, com.i_a, com.i_b
    imp = st["impulse"]
    limit_state = st["limit_state"]

    # motor
    motor_on = blk.enable_motor & (limit_state != LIMIT_EQUAL) & m
    cdot_m = dot(data.axis, vb - va) + data.a2 * wb - data.a1 * wa
    lam = data.motor_mass * (blk.motor_speed - cdot_m)
    max_imp = dt * blk.max_motor_force
    new_mi = _clip(st["motor_impulse"] + lam, -max_imp, max_imp)
    dlam = torch.where(motor_on, new_mi - st["motor_impulse"], 0.0)
    motor_impulse = torch.where(motor_on, new_mi, st["motor_impulse"])
    p = dlam[..., None] * data.axis
    va = va - mA[..., None] * p
    wa = wa - iA * dlam * data.a1
    vb = vb + mB[..., None] * p
    wb = wb + iB * dlam * data.a2

    cdot1x = dot(data.perp, vb - va) + data.s2 * wb - data.s1 * wa
    cdot1y = wb - wa

    # limit branch: 3x3 + z clamp + 2x2 re-solve
    limit_on = blk.enable_limit & (limit_state != LIMIT_INACTIVE) & m
    cdot2 = dot(data.axis, vb - va) + data.a2 * wb - data.a1 * wa
    _, _, dfz = _solve33(data.k11, data.k12, data.k13, data.k22,
                         data.k23, data.k33, -cdot1x, -cdot1y, -cdot2)
    f1z = imp[..., 2]
    z_new = f1z + dfz
    z_new = torch.where(limit_state == LIMIT_AT_LOWER, torch.clamp_min(z_new, 0.0), z_new)
    z_new = torch.where(limit_state == LIMIT_AT_UPPER, torch.clamp_max(z_new, 0.0), z_new)
    bx = -cdot1x - (z_new - f1z) * data.k13
    by = -cdot1y - (z_new - f1z) * data.k23
    f2x, f2y = _solve22(data.k11, data.k12, data.k22, bx, by)
    imp_l = torch.stack([imp[..., 0] + f2x, imp[..., 1] + f2y, z_new], -1)

    # no-limit branch: 2x2
    gx, gy = _solve22(data.k11, data.k12, data.k22, -cdot1x, -cdot1y)
    imp_n = torch.stack([imp[..., 0] + gx, imp[..., 1] + gy, imp[..., 2]], -1)

    imp_new = torch.where(limit_on[..., None], imp_l, imp_n)
    imp_new = torch.where(m[..., None], imp_new, imp)
    df = imp_new - imp
    p = df[..., 0:1] * data.perp + df[..., 2:3] * data.axis
    l_a = df[..., 0] * data.s1 + df[..., 1] + df[..., 2] * data.a1
    l_b = df[..., 0] * data.s2 + df[..., 1] + df[..., 2] * data.a2
    va = va - mA[..., None] * p
    wa = wa - iA * l_a
    vb = vb + mB[..., None] * p
    wb = wb + iB * l_b

    st = {**st, "impulse": imp_new, "motor_impulse": motor_impulse}
    v, w = _apply(com, v, w, mask, va - va0, wa - wa0, vb - vb0, wb - wb0)
    return st, v, w


def _prismatic_position(blk, data, st, c, a, mask):
    com = data.com
    m = mask & com.active
    aa, ab = take(a, com.body_a), take(a, com.body_b)
    qa, r_a, r_b = _anchors(blk, com, aa, ab)
    d = take(c, com.body_b) + r_b - take(c, com.body_a) - r_a
    axis, perp, a1, a2, s1, s2, (k11, k12, k13, k22, k23, k33) = \
        _prismatic_frame(blk, com, qa, r_a, r_b, d)
    mA, mB, iA, iB = com.m_a, com.m_b, com.i_a, com.i_b

    c1x = dot(perp, d)
    c1y = ab - aa - blk.reference_angle
    linear_error = torch.abs(c1x)
    angular_error = torch.abs(c1y)

    translation = dot(axis, d)
    mlc = settings.MAX_LINEAR_CORRECTION
    equal = (torch.abs(blk.upper_translation - blk.lower_translation)
             < 2.0 * settings.LINEAR_SLOP)
    lower_v = _clip(translation - blk.lower_translation + settings.LINEAR_SLOP,
                    -mlc, 0.0)
    upper_v = _clip(translation - blk.upper_translation - settings.LINEAR_SLOP,
                    0.0, mlc)
    eq_v = _clip(translation, -mlc, mlc)
    at_lower = translation <= blk.lower_translation
    at_upper = translation >= blk.upper_translation
    active = blk.enable_limit & (equal | at_lower | at_upper)
    zero = torch.zeros_like(translation)
    c2 = torch.where(equal, eq_v, torch.where(at_lower, lower_v,
                                              torch.where(at_upper, upper_v, zero)))
    linear_error = torch.where(
        active,
        torch.maximum(linear_error,
                      torch.where(equal, torch.abs(translation),
                                  torch.where(at_lower,
                                              blk.lower_translation - translation,
                                              translation - blk.upper_translation))),
        linear_error)

    i3x, i3y, i3z = _solve33(k11, k12, k13, k22, k23, k33, -c1x, -c1y, -c2)
    i2x, i2y = _solve22(k11, k12, k22, -c1x, -c1y)
    ix = torch.where(active, i3x, i2x)
    iy = torch.where(active, i3y, i2y)
    iz = torch.where(active, i3z, 0.0)

    p = ix[..., None] * perp + iz[..., None] * axis
    l_a = ix * s1 + iy + iz * a1
    l_b = ix * s2 + iy + iz * a2
    c, a = _scatter(com, c, a, m, -mA[..., None] * p, -iA * l_a,
                    mB[..., None] * p, iB * l_b)
    ok = ((linear_error <= settings.LINEAR_SLOP)
          & (angular_error <= settings.ANGULAR_SLOP)) | ~m
    return c, a, ok


# ==========================================================================
# weld (b2WeldJoint.cpp): rigid 3-DOF lock with optional softness
# ==========================================================================


class WeldData(NamedTuple):
    com: _Common
    r_a: torch.Tensor
    r_b: torch.Tensor
    k11: torch.Tensor
    k12: torch.Tensor
    k13: torch.Tensor
    k22: torch.Tensor
    k23: torch.Tensor
    k33: torch.Tensor
    ez_mass: torch.Tensor   # soft angular mass (1 / (iA + iB + gamma))
    gamma: torch.Tensor
    bias: torch.Tensor
    soft: torch.Tensor


def _weld_init(blk, bodies, awake, color, dt_ratio, warm, dt):
    com = _common(blk, bodies, awake, color)
    a_a, a_b = take(bodies.a, com.body_a), take(bodies.a, com.body_b)
    _, r_a, r_b = _anchors(blk, com, a_a, a_b)
    kk = _point_mass(r_a, r_b, com.m_a, com.m_b, com.i_a, com.i_b)
    k33 = kk[5]
    soft = blk.frequency > 0.0
    inv_m = _inv(k33, k33 > 0.0)
    gamma, bias = _spring(inv_m, blk.frequency, blk.damping_ratio,
                          a_b - a_a - blk.reference_angle, dt)
    ez_raw = k33 + gamma
    ez_mass = _inv(ez_raw, ez_raw != 0.0)
    gamma = torch.where(soft, gamma, 0.0)
    bias = torch.where(soft, bias, 0.0)
    imp = _warm_scaled(blk.impulse, dt_ratio, warm)
    return WeldData(com, r_a, r_b, *kk, ez_mass, gamma, bias, soft), {"impulse": imp}


def _weld_warm(data, st, v, w):
    com = data.com
    imp = st["impulse"]
    p = imp[..., :2]
    return _apply(com, v, w, _all_lanes(com),
                  -com.m_a[..., None] * p,
                  -com.i_a * (cross_vv(data.r_a, p) + imp[..., 2]),
                  com.m_b[..., None] * p,
                  com.i_b * (cross_vv(data.r_b, p) + imp[..., 2]))


def _weld_velocity(blk, data, st, v, w, dt, mask):
    com = data.com
    m = mask & com.active
    va0, wa0 = take(v, com.body_a), take(w, com.body_a)
    vb0, wb0 = take(v, com.body_b), take(w, com.body_b)
    va, wa, vb, wb = va0, wa0, vb0, wb0
    imp = st["impulse"]

    # soft path: angular spring then 2x2 linear
    cdot2_s = wb - wa
    i2 = -data.ez_mass * (cdot2_s + data.bias + data.gamma * imp[..., 2])
    wa_s = wa - com.i_a * i2
    wb_s = wb + com.i_b * i2
    cdot1_s = vb + cross_sv(wb_s, data.r_b) - va - cross_sv(wa_s, data.r_a)
    sx, sy = _solve22(data.k11, data.k12, data.k22,
                      -cdot1_s[..., 0], -cdot1_s[..., 1])
    imp_soft = torch.stack([imp[..., 0] + sx, imp[..., 1] + sy, imp[..., 2] + i2], -1)

    # rigid path: full 3x3
    cdot1_r = vb + cross_sv(wb, data.r_b) - va - cross_sv(wa, data.r_a)
    cdot2_r = wb - wa
    rx, ry, rz = _solve33(data.k11, data.k12, data.k13, data.k22, data.k23,
                          data.k33, -cdot1_r[..., 0], -cdot1_r[..., 1], -cdot2_r)
    imp_rigid = torch.stack([imp[..., 0] + rx, imp[..., 1] + ry, imp[..., 2] + rz], -1)

    imp_new = torch.where(data.soft[..., None], imp_soft, imp_rigid)
    imp_new = torch.where(m[..., None], imp_new, imp)
    d_imp = imp_new - imp
    p = d_imp[..., :2]
    va = va - com.m_a[..., None] * p
    wa = wa - com.i_a * (cross_vv(data.r_a, p) + d_imp[..., 2])
    vb = vb + com.m_b[..., None] * p
    wb = wb + com.i_b * (cross_vv(data.r_b, p) + d_imp[..., 2])
    v, w = _apply(com, v, w, mask, va - va0, wa - wa0, vb - vb0, wb - wb0)
    return {**st, "impulse": imp_new}, v, w


def _weld_position(blk, data, st, c, a, mask):
    com = data.com
    m = mask & com.active
    aa, ab = take(a, com.body_a), take(a, com.body_b)
    _, r_a, r_b = _anchors(blk, com, aa, ab)
    mA, mB, iA, iB = com.m_a, com.m_b, com.i_a, com.i_b
    k11, k12, k13, k22, k23, k33 = _point_mass(r_a, r_b, mA, mB, iA, iB)
    c1 = take(c, com.body_b) + r_b - take(c, com.body_a) - r_a
    c2 = ab - aa - blk.reference_angle
    pos_err = torch.sqrt(dot(c1, c1))
    # rigid: 3x3 (or 2x2 if k33 == 0); soft: 2x2, no angular correction
    r3x, r3y, r3z = _solve33(k11, k12, k13, k22, k23, k33,
                             -c1[..., 0], -c1[..., 1], -c2)
    r2x, r2y = _solve22(k11, k12, k22, -c1[..., 0], -c1[..., 1])
    use2 = data.soft | (k33 == 0.0)
    px = torch.where(use2, r2x, r3x)
    py = torch.where(use2, r2y, r3y)
    pz = torch.where(use2, 0.0, r3z)
    ang_err = torch.where(data.soft, 0.0, torch.abs(c2))
    p = torch.stack([px, py], -1)
    c, a = _scatter(com, c, a, m,
                    -mA[..., None] * p, -iA * (cross_vv(r_a, p) + pz),
                    mB[..., None] * p, iB * (cross_vv(r_b, p) + pz))
    ok = ((pos_err <= settings.LINEAR_SLOP)
          & (ang_err <= settings.ANGULAR_SLOP)) | ~m
    return c, a, ok


# ==========================================================================
# mouse (b2MouseJoint.cpp): soft drag of body B toward a world target
# ==========================================================================


class MouseData(NamedTuple):
    com: _Common
    r_b: torch.Tensor
    m11: torch.Tensor
    m12: torch.Tensor
    m22: torch.Tensor
    c_beta: torch.Tensor   # (W,J,2) beta * (cB + rB - target)
    gamma: torch.Tensor


def _mouse_init(blk, bodies, awake, color, dt_ratio, warm, dt):
    com = _common(blk, bodies, awake, color)
    r_b = rot_vec(rot_from_angle(take(bodies.a, com.body_b)),
                  blk.local_anchor_b - com.lc_b)
    mass_b = _inv(com.m_b, com.m_b > 0.0)
    omega = 2.0 * math.pi * blk.frequency
    d = 2.0 * mass_b * blk.damping_ratio * omega
    k = mass_b * omega * omega
    gamma_raw = dt * (d + dt * k)
    gamma = _inv(gamma_raw, gamma_raw != 0.0)
    beta = dt * k * gamma
    k11 = com.m_b + com.i_b * r_b[..., 1] ** 2 + gamma
    k12 = -com.i_b * r_b[..., 0] * r_b[..., 1]
    k22 = com.m_b + com.i_b * r_b[..., 0] ** 2 + gamma
    det = k11 * k22 - k12 * k12
    inv = _inv(det, det != 0.0)
    c_beta = beta[..., None] * (take(bodies.c, com.body_b) + r_b - blk.target)
    imp = _warm_scaled(blk.impulse, dt_ratio, warm)
    return (MouseData(com, r_b, inv * k22, -inv * k12, inv * k11, c_beta, gamma),
            {"impulse": imp})


def _mouse_warm(data, st, v, w):
    com = data.com
    p = st["impulse"]
    # the reference damps wB by 0.98 at init (b2MouseJoint.cpp), whether
    # or not warm starting is on
    damp = torch.where(com.active, 0.98, 1.0).to(w.dtype)
    w = w * torch.ones_like(w).scatter_reduce_(1, com.body_b, damp, "prod")
    return _apply(com, v, w, _all_lanes(com), torch.zeros_like(p),
                  torch.zeros_like(com.i_a), com.m_b[..., None] * p,
                  com.i_b * cross_vv(data.r_b, p))


def _mouse_velocity(blk, data, st, v, w, dt, mask):
    com = data.com
    m = mask & com.active
    imp = st["impulse"]
    cdot = (take(v, com.body_b) + cross_sv(take(w, com.body_b), data.r_b)
            + data.c_beta + data.gamma[..., None] * imp)
    ix = -(data.m11 * cdot[..., 0] + data.m12 * cdot[..., 1])
    iy = -(data.m12 * cdot[..., 0] + data.m22 * cdot[..., 1])
    imp_new = _clamp_length(imp + torch.stack([ix, iy], -1), dt * blk.max_force)
    d_imp = torch.where(m[..., None], imp_new - imp, 0.0)
    v, w = _apply(com, v, w, mask, torch.zeros_like(d_imp), torch.zeros_like(com.i_a),
                  com.m_b[..., None] * d_imp, com.i_b * cross_vv(data.r_b, d_imp))
    return {**st, "impulse": torch.where(m[..., None], imp_new, imp)}, v, w


def _no_position(blk, data, st, c, a, mask):
    """Mouse, friction and motor joints correct no position."""
    return c, a, torch.ones_like(mask)


def _clamp_length(x, max_len):
    """x (..., 2) scaled down to length `max_len` where it is longer."""
    ln = torch.sqrt(dot(x, x))
    scale = torch.where(ln > max_len, max_len / torch.where(ln > 0, ln, 1.0), 1.0)
    return x * scale[..., None]


# ==========================================================================
# friction (b2FrictionJoint.cpp): top-down friction
# ==========================================================================


class FrictionData(NamedTuple):
    com: _Common
    r_a: torch.Tensor
    r_b: torch.Tensor
    lm11: torch.Tensor
    lm12: torch.Tensor
    lm22: torch.Tensor
    angular_mass: torch.Tensor


def _lin22(com, r_a, r_b):
    """The inverse of the point-to-point 2x2 mass matrix."""
    mA, mB, iA, iB = com.m_a, com.m_b, com.i_a, com.i_b
    k11 = mA + mB + iA * r_a[..., 1] ** 2 + iB * r_b[..., 1] ** 2
    k12 = -iA * r_a[..., 0] * r_a[..., 1] - iB * r_b[..., 0] * r_b[..., 1]
    k22 = mA + mB + iA * r_a[..., 0] ** 2 + iB * r_b[..., 0] ** 2
    det = k11 * k22 - k12 * k12
    inv = _inv(det, det != 0.0)
    return inv * k22, -inv * k12, inv * k11


def _friction_init(blk, bodies, awake, color, dt_ratio, warm):
    com = _common(blk, bodies, awake, color)
    _, r_a, r_b = _anchors(blk, com, take(bodies.a, com.body_a),
                           take(bodies.a, com.body_b))
    k33 = com.i_a + com.i_b
    return (FrictionData(com, r_a, r_b, *_lin22(com, r_a, r_b), _inv(k33, k33 > 0.0)),
            {"linear_impulse": _warm_scaled(blk.linear_impulse, dt_ratio, warm),
             "angular_impulse": _warm_scaled(blk.angular_impulse, dt_ratio, warm)})


def _friction_warm(data, st, v, w):
    com = data.com
    p = st["linear_impulse"]
    ai = st["angular_impulse"]
    return _apply(com, v, w, _all_lanes(com),
                  -com.m_a[..., None] * p, -com.i_a * (cross_vv(data.r_a, p) + ai),
                  com.m_b[..., None] * p, com.i_b * (cross_vv(data.r_b, p) + ai))


def _friction_like_velocity(blk, data, st, v, w, dt, mask, ang_bias, lin_bias):
    """The friction joint's velocity pass, and the motor joint's with its
    position-error biases (b2FrictionJoint.cpp, b2MotorJoint.cpp
    SolveVelocityConstraints): angular, then linear, each impulse clamped
    to dt times its maximum."""
    com = data.com
    m = mask & com.active
    va0, wa0 = take(v, com.body_a), take(w, com.body_a)
    vb0, wb0 = take(v, com.body_b), take(w, com.body_b)
    va, wa, vb, wb = va0, wa0, vb0, wb0
    # angular
    cdot_a = wb - wa
    if ang_bias is not None:
        cdot_a = cdot_a + ang_bias
    lam = -data.angular_mass * cdot_a
    max_a = dt * blk.max_torque
    ai = st["angular_impulse"]
    ai_new = _clip(ai + lam, -max_a, max_a)
    d_ai = torch.where(m, ai_new - ai, 0.0)
    wa = wa - com.i_a * d_ai
    wb = wb + com.i_b * d_ai
    # linear
    cdot = vb + cross_sv(wb, data.r_b) - va - cross_sv(wa, data.r_a)
    if lin_bias is not None:
        cdot = cdot + lin_bias
    ix = -(data.lm11 * cdot[..., 0] + data.lm12 * cdot[..., 1])
    iy = -(data.lm12 * cdot[..., 0] + data.lm22 * cdot[..., 1])
    li = st["linear_impulse"]
    li_new = _clamp_length(li + torch.stack([ix, iy], -1), dt * blk.max_force)
    d_li = torch.where(m[..., None], li_new - li, 0.0)
    va = va - com.m_a[..., None] * d_li
    wa = wa - com.i_a * cross_vv(data.r_a, d_li)
    vb = vb + com.m_b[..., None] * d_li
    wb = wb + com.i_b * cross_vv(data.r_b, d_li)
    v, w = _apply(com, v, w, mask, va - va0, wa - wa0, vb - vb0, wb - wb0)
    return {**st, "linear_impulse": torch.where(m[..., None], li_new, li),
            "angular_impulse": torch.where(m, ai_new, ai)}, v, w


def _friction_velocity(blk, data, st, v, w, dt, mask):
    return _friction_like_velocity(blk, data, st, v, w, dt, mask, None, None)


# ==========================================================================
# rope (b2RopeJoint.cpp): a maximum distance
# ==========================================================================


class RopeData(NamedTuple):
    com: _Common
    r_a: torch.Tensor
    r_b: torch.Tensor
    u: torch.Tensor
    mass: torch.Tensor
    length: torch.Tensor


def _rope_init(blk, bodies, awake, color, dt_ratio, warm):
    com = _common(blk, bodies, awake, color)
    _, r_a, r_b = _anchors(blk, com, take(bodies.a, com.body_a),
                           take(bodies.a, com.body_b))
    u = take(bodies.c, com.body_b) + r_b - take(bodies.c, com.body_a) - r_a
    length = torch.sqrt(dot(u, u))
    short = length <= settings.LINEAR_SLOP
    u = torch.where(short[..., None], 0.0,
                    u / torch.where(length > 0, length, 1.0)[..., None])
    cr_a = cross_vv(r_a, u)
    cr_b = cross_vv(r_b, u)
    inv_mass = com.m_a + com.i_a * cr_a ** 2 + com.m_b + com.i_b * cr_b ** 2
    mass = torch.where(short, 0.0, _inv(inv_mass, inv_mass != 0.0))
    imp = torch.where(short, 0.0, _warm_scaled(blk.impulse, dt_ratio, warm))
    return RopeData(com, r_a, r_b, u, mass, length), {"impulse": imp}


def _rope_velocity(blk, data, st, v, w, dt, mask):
    com = data.com
    m = mask & com.active
    vp_a = take(v, com.body_a) + cross_sv(take(w, com.body_a), data.r_a)
    vp_b = take(v, com.body_b) + cross_sv(take(w, com.body_b), data.r_b)
    c_err = data.length - blk.max_length
    cdot = dot(data.u, vp_b - vp_a)
    cdot = cdot + torch.where(c_err < 0.0, (1.0 / dt) * c_err, 0.0)
    lam = -data.mass * cdot
    imp = st["impulse"]
    imp_new = torch.clamp_max(imp + lam, 0.0)
    d_imp = torch.where(m, imp_new - imp, 0.0)
    v, w = _distance_impulse(com, data, v, w, mask, d_imp[..., None] * data.u)
    return {**st, "impulse": torch.where(m, imp_new, imp)}, v, w


def _rope_position(blk, data, st, c, a, mask):
    com = data.com
    m = mask & com.active
    _, r_a, r_b = _anchors(blk, com, take(a, com.body_a), take(a, com.body_b))
    u = take(c, com.body_b) + r_b - take(c, com.body_a) - r_a
    length = torch.sqrt(dot(u, u))
    u = u / torch.where(length > 0, length, 1.0)[..., None]
    cc = _clip(length - blk.max_length, 0.0, settings.MAX_LINEAR_CORRECTION)
    lam = torch.where(m, -data.mass * cc, 0.0)
    p = lam[..., None] * u
    c, a = _scatter(com, c, a, m,
                    -com.m_a[..., None] * p, -com.i_a * cross_vv(r_a, p),
                    com.m_b[..., None] * p, com.i_b * cross_vv(r_b, p))
    ok = (length - blk.max_length < settings.LINEAR_SLOP) | ~m
    return c, a, ok


# ==========================================================================
# motor (b2MotorJoint.cpp): drives the relative transform to its offsets
# ==========================================================================


class MotorData(NamedTuple):
    com: _Common
    r_a: torch.Tensor
    r_b: torch.Tensor
    lm11: torch.Tensor
    lm12: torch.Tensor
    lm22: torch.Tensor
    angular_mass: torch.Tensor
    linear_error: torch.Tensor   # (W,J,2)
    angular_error: torch.Tensor


def _motor_init(blk, bodies, awake, color, dt_ratio, warm):
    com = _common(blk, bodies, awake, color)
    a_a, a_b = take(bodies.a, com.body_a), take(bodies.a, com.body_b)
    r_a = rot_vec(rot_from_angle(a_a), blk.linear_offset - com.lc_a)
    r_b = rot_vec(rot_from_angle(a_b), -com.lc_b)
    k33 = com.i_a + com.i_b
    lin_err = take(bodies.c, com.body_b) + r_b - take(bodies.c, com.body_a) - r_a
    ang_err = a_b - a_a - blk.angular_offset
    return (MotorData(com, r_a, r_b, *_lin22(com, r_a, r_b), _inv(k33, k33 > 0.0),
                      lin_err, ang_err),
            {"linear_impulse": _warm_scaled(blk.linear_impulse, dt_ratio, warm),
             "angular_impulse": _warm_scaled(blk.angular_impulse, dt_ratio, warm)})


def _motor_velocity(blk, data, st, v, w, dt, mask):
    inv_h = 1.0 / dt
    return _friction_like_velocity(
        blk, data, st, v, w, dt, mask,
        inv_h * blk.correction_factor * data.angular_error,
        inv_h * blk.correction_factor[..., None] * data.linear_error)


# ==========================================================================
# wheel (b2WheelJoint.cpp): suspension axis, spring and motor
# ==========================================================================


class WheelData(NamedTuple):
    com: _Common
    ax: torch.Tensor
    ay: torch.Tensor
    s_ax: torch.Tensor
    s_bx: torch.Tensor
    s_ay: torch.Tensor
    s_by: torch.Tensor
    mass: torch.Tensor
    spring_mass: torch.Tensor
    motor_mass: torch.Tensor
    bias: torch.Tensor
    gamma: torch.Tensor


def _wheel_perp(blk, qa, d, r_a, r_b):
    """The suspension's perpendicular axis and its lever arms."""
    local_y = torch.stack([-blk.local_axis_a[..., 1], blk.local_axis_a[..., 0]], -1)
    ay = rot_vec(qa, local_y)
    return ay, cross_vv(d + r_a, ay), cross_vv(r_b, ay)


def _wheel_init(blk, bodies, awake, color, dt_ratio, warm, dt):
    com = _common(blk, bodies, awake, color)
    qa, r_a, r_b = _anchors(blk, com, take(bodies.a, com.body_a),
                            take(bodies.a, com.body_b))
    d = take(bodies.c, com.body_b) + r_b - take(bodies.c, com.body_a) - r_a
    mA, mB, iA, iB = com.m_a, com.m_b, com.i_a, com.i_b

    ay, s_ay, s_by = _wheel_perp(blk, qa, d, r_a, r_b)
    mass_raw = mA + mB + iA * s_ay ** 2 + iB * s_by ** 2
    mass = _inv(mass_raw, mass_raw > 0.0)

    ax = rot_vec(qa, blk.local_axis_a)
    s_ax = cross_vv(d + r_a, ax)
    s_bx = cross_vv(r_b, ax)
    inv_m = mA + mB + iA * s_ax ** 2 + iB * s_bx ** 2
    sm0 = _inv(inv_m, inv_m > 0.0)
    cc = dot(d, ax)
    omega = 2.0 * math.pi * blk.frequency
    damp = 2.0 * sm0 * blk.damping_ratio * omega
    k = sm0 * omega * omega
    gamma_raw = dt * (damp + dt * k)
    gamma = _inv(gamma_raw, gamma_raw > 0.0)
    bias = cc * dt * k * gamma
    sm_raw = inv_m + gamma
    spring_mass = _inv(sm_raw, sm_raw > 0.0)
    has_spring = (blk.frequency > 0.0) & (inv_m > 0.0)
    spring_mass = torch.where(has_spring, spring_mass, 0.0)
    bias = torch.where(has_spring, bias, 0.0)
    gamma = torch.where(has_spring, gamma, 0.0)

    mm_raw = iA + iB
    motor_mass = torch.where(blk.enable_motor, _inv(mm_raw, mm_raw > 0.0), 0.0)

    imp = _warm_scaled(blk.impulse, dt_ratio, warm)
    si = torch.where(blk.frequency > 0.0,
                     _warm_scaled(blk.spring_impulse, dt_ratio, warm), 0.0)
    mi = torch.where(blk.enable_motor,
                     _warm_scaled(blk.motor_impulse, dt_ratio, warm), 0.0)
    data = WheelData(com, ax, ay, s_ax, s_bx, s_ay, s_by, mass, spring_mass,
                     motor_mass, bias, gamma)
    return data, {"impulse": imp, "spring_impulse": si, "motor_impulse": mi}


def _wheel_warm(data, st, v, w):
    com = data.com
    imp, si, mi = st["impulse"], st["spring_impulse"], st["motor_impulse"]
    p = imp[..., None] * data.ay + si[..., None] * data.ax
    l_a = imp * data.s_ay + si * data.s_ax + mi
    l_b = imp * data.s_by + si * data.s_bx + mi
    return _apply(com, v, w, _all_lanes(com),
                  -com.m_a[..., None] * p, -com.i_a * l_a,
                  com.m_b[..., None] * p, com.i_b * l_b)


def _wheel_velocity(blk, data, st, v, w, dt, mask):
    com = data.com
    m = mask & com.active
    va0, wa0 = take(v, com.body_a), take(w, com.body_a)
    vb0, wb0 = take(v, com.body_b), take(w, com.body_b)
    va, wa, vb, wb = va0, wa0, vb0, wb0
    mA, mB, iA, iB = com.m_a, com.m_b, com.i_a, com.i_b

    # spring
    cdot = dot(data.ax, vb - va) + data.s_bx * wb - data.s_ax * wa
    lam = -data.spring_mass * (cdot + data.bias + data.gamma * st["spring_impulse"])
    lam = torch.where(m, lam, 0.0)
    si = st["spring_impulse"] + lam
    p = lam[..., None] * data.ax
    va = va - mA[..., None] * p
    wa = wa - iA * lam * data.s_ax
    vb = vb + mB[..., None] * p
    wb = wb + iB * lam * data.s_bx

    # motor
    cdot = wb - wa - blk.motor_speed
    lam = -data.motor_mass * cdot
    max_i = dt * blk.max_motor_torque
    mi_new = _clip(st["motor_impulse"] + lam, -max_i, max_i)
    on = m & blk.enable_motor
    dlam = torch.where(on, mi_new - st["motor_impulse"], 0.0)
    mi = torch.where(on, mi_new, st["motor_impulse"])
    wa = wa - iA * dlam
    wb = wb + iB * dlam

    # point on line
    cdot = dot(data.ay, vb - va) + data.s_by * wb - data.s_ay * wa
    lam = torch.where(m, -data.mass * cdot, 0.0)
    imp = st["impulse"] + lam
    p = lam[..., None] * data.ay
    va = va - mA[..., None] * p
    wa = wa - iA * lam * data.s_ay
    vb = vb + mB[..., None] * p
    wb = wb + iB * lam * data.s_by

    v, w = _apply(com, v, w, mask, va - va0, wa - wa0, vb - vb0, wb - wb0)
    return {**st, "impulse": imp, "spring_impulse": si, "motor_impulse": mi}, v, w


def _wheel_position(blk, data, st, c, a, mask):
    com = data.com
    m = mask & com.active
    qa, r_a, r_b = _anchors(blk, com, take(a, com.body_a), take(a, com.body_b))
    d = take(c, com.body_b) - take(c, com.body_a) + r_b - r_a
    ay, s_ay, s_by = _wheel_perp(blk, qa, d, r_a, r_b)
    cc = dot(d, ay)
    # the effective mass keeps the lever arms of the step's start, as in
    # the JAX package
    k = com.m_a + com.m_b + com.i_a * data.s_ay ** 2 + com.i_b * data.s_by ** 2
    lam = torch.where(m & (k != 0.0), -cc / torch.where(k != 0.0, k, 1.0), 0.0)
    p = lam[..., None] * ay
    c, a = _scatter(com, c, a, m, -com.m_a[..., None] * p, -com.i_a * lam * s_ay,
                    com.m_b[..., None] * p, com.i_b * lam * s_by)
    ok = (torch.abs(cc) <= settings.LINEAR_SLOP) | ~m
    return c, a, ok


# ==========================================================================
# pulley (b2PulleyJoint.cpp): two ropes over fixed ground anchors, a ratio
# ==========================================================================


class PulleyData(NamedTuple):
    com: _Common
    r_a: torch.Tensor
    r_b: torch.Tensor
    u_a: torch.Tensor
    u_b: torch.Tensor
    mass: torch.Tensor


def _pulley_frame(blk, com, c, a):
    """Anchor arms, rope directions and lengths, and the effective mass at
    body centers c and angles a."""
    _, r_a, r_b = _anchors(blk, com, take(a, com.body_a), take(a, com.body_b))
    u_a = take(c, com.body_a) + r_a - blk.ground_anchor_a
    u_b = take(c, com.body_b) + r_b - blk.ground_anchor_b
    la = torch.sqrt(dot(u_a, u_a))
    lb = torch.sqrt(dot(u_b, u_b))
    u_a = torch.where((la > 10.0 * settings.LINEAR_SLOP)[..., None],
                      u_a / torch.where(la > 0, la, 1.0)[..., None], 0.0)
    u_b = torch.where((lb > 10.0 * settings.LINEAR_SLOP)[..., None],
                      u_b / torch.where(lb > 0, lb, 1.0)[..., None], 0.0)
    ru_a = cross_vv(r_a, u_a)
    ru_b = cross_vv(r_b, u_b)
    m_a = com.m_a + com.i_a * ru_a ** 2
    m_b = com.m_b + com.i_b * ru_b ** 2
    mass_raw = m_a + blk.ratio ** 2 * m_b
    return r_a, r_b, u_a, u_b, la, lb, _inv(mass_raw, mass_raw > 0.0)


def _pulley_init(blk, bodies, awake, color, dt_ratio, warm):
    com = _common(blk, bodies, awake, color)
    r_a, r_b, u_a, u_b, _, _, mass = _pulley_frame(blk, com, bodies.c, bodies.a)
    return (PulleyData(com, r_a, r_b, u_a, u_b, mass),
            {"impulse": _warm_scaled(blk.impulse, dt_ratio, warm), "ratio": blk.ratio})


def _pulley_impulse(com, r_a, r_b, u_a, u_b, ratio, lin, ang, mask, lam):
    pa = -lam[..., None] * u_a
    pb = (-ratio * lam)[..., None] * u_b
    return _scatter(com, lin, ang, mask,
                    com.m_a[..., None] * pa, com.i_a * cross_vv(r_a, pa),
                    com.m_b[..., None] * pb, com.i_b * cross_vv(r_b, pb))


def _pulley_warm(data, st, v, w):
    com = data.com
    return _pulley_impulse(com, data.r_a, data.r_b, data.u_a, data.u_b, st["ratio"],
                           v, w, com.active, st["impulse"])


def _pulley_velocity(blk, data, st, v, w, dt, mask):
    com = data.com
    m = mask & com.active
    vp_a = take(v, com.body_a) + cross_sv(take(w, com.body_a), data.r_a)
    vp_b = take(v, com.body_b) + cross_sv(take(w, com.body_b), data.r_b)
    cdot = -dot(data.u_a, vp_a) - blk.ratio * dot(data.u_b, vp_b)
    lam = torch.where(m, -data.mass * cdot, 0.0)
    v, w = _pulley_impulse(com, data.r_a, data.r_b, data.u_a, data.u_b, blk.ratio,
                           v, w, m, lam)
    return {**st, "impulse": st["impulse"] + lam}, v, w


def _pulley_position(blk, data, st, c, a, mask):
    com = data.com
    m = mask & com.active
    r_a, r_b, u_a, u_b, la, lb, mass = _pulley_frame(blk, com, c, a)
    cc = (blk.length_a + blk.ratio * blk.length_b) - la - blk.ratio * lb
    lam = torch.where(m, -mass * cc, 0.0)
    c, a = _pulley_impulse(com, r_a, r_b, u_a, u_b, blk.ratio, c, a, m, lam)
    ok = (torch.abs(cc) < settings.LINEAR_SLOP) | ~m
    return c, a, ok


# ==========================================================================
# gear (b2GearJoint.cpp): couples two revolute or prismatic joints,
# C = (coordinate1 + ratio * coordinate2) - constant = 0
# ==========================================================================
#
# A gear writes to four bodies (A = joint1.bodyB, B = joint2.bodyB,
# C = joint1.bodyA, D = joint2.bodyA) and shares bodies with the joints it
# couples, so it stays out of the two-body coloring: after the colored
# blocks, the gears run one slot at a time in slot order, each slot over
# all worlds at once, as in the JAX package. Its four deltas are summed
# (`add_rows`) where JAX adds them in turn; the two differ in the last bits
# only where two roles are the same dynamic body.


class GearData(NamedTuple):
    active: torch.Tensor   # (W,J)
    body: torch.Tensor     # (W,J,4) i64 bodies A, B, C, D
    m: torch.Tensor        # (W,J,4) inverse masses
    i: torch.Tensor        # (W,J,4) inverse inertias
    m_signed: torch.Tensor  # (W,J,4) m, negated at C and D
    i_signed: torch.Tensor
    lc: torch.Tensor       # (W,J,4,2) local centers
    jv_ac: torch.Tensor    # (W,J,2)
    jv_bd: torch.Tensor
    jw: torch.Tensor       # (W,J,4) angular Jacobian terms of A, B, C, D
    mass: torch.Tensor


def _gear_jacobian(blk, lc, ang):
    """The gear's Jacobian terms at body angles `ang` (..., 4), bodies in
    A, B, C, D order (b2GearJoint::InitVelocityConstraints,
    b2GearJoint.cpp:169-208)."""
    rev1 = blk.joint1_type == 0
    rev2 = blk.joint2_type == 0
    qa, qb, qc, qd = (rot_from_angle(ang[..., k]) for k in range(4))
    # joint 1 (A, C), prismatic branch
    u1 = rot_vec(qc, blk.local_axis_c)
    r_c = rot_vec(qc, blk.local_anchor_c - lc[..., 2, :])
    r_a = rot_vec(qa, blk.local_anchor_a - lc[..., 0, :])
    jv_ac = torch.where(rev1[..., None], 0.0, u1)
    jw_a = torch.where(rev1, 1.0, cross_vv(r_a, u1))
    jw_c = torch.where(rev1, 1.0, cross_vv(r_c, u1))
    # joint 2 (B, D), prismatic branch
    u2 = rot_vec(qd, blk.local_axis_d)
    r_d = rot_vec(qd, blk.local_anchor_d - lc[..., 3, :])
    r_b = rot_vec(qb, blk.local_anchor_b - lc[..., 1, :])
    jv_bd = torch.where(rev2[..., None], 0.0, blk.ratio[..., None] * u2)
    jw_b = torch.where(rev2, blk.ratio, blk.ratio * cross_vv(r_b, u2))
    jw_d = torch.where(rev2, blk.ratio, blk.ratio * cross_vv(r_d, u2))
    return jv_ac, jv_bd, torch.stack([jw_a, jw_b, jw_c, jw_d], -1), rev1, rev2, r_a, r_b


def _gear_mass(blk, m, i, jw, rev1, rev2):
    """The constraint's inverse effective mass (b2GearJoint.cpp:203-208)."""
    mass1 = torch.where(rev1, i[..., 0] + i[..., 2],
                        m[..., 2] + m[..., 0] + i[..., 2] * jw[..., 2] ** 2
                        + i[..., 0] * jw[..., 0] ** 2)
    mass2 = torch.where(rev2, blk.ratio ** 2 * (i[..., 1] + i[..., 3]),
                        blk.ratio ** 2 * (m[..., 3] + m[..., 1])
                        + i[..., 3] * jw[..., 3] ** 2 + i[..., 1] * jw[..., 1] ** 2)
    return mass1 + mass2


def _gear_init(blk, bodies, awake, warm):
    body = torch.stack([blk.body_a, blk.body_b, blk.body_c, blk.body_d],
                       -1).clamp_min(0).long()
    flat = body.flatten(1)

    def per_body(x):
        return take(x, flat).reshape(body.shape + x.shape[2:])

    dyn = per_body(bodies.is_dynamic) & per_body(awake)
    active = blk.active & (dyn[..., 0] | dyn[..., 1])
    m, i, lc = per_body(bodies.inv_mass), per_body(bodies.inv_inertia), \
        per_body(bodies.local_center)
    jv_ac, jv_bd, jw, rev1, rev2, _, _ = _gear_jacobian(blk, lc, per_body(bodies.a))
    mass_raw = _gear_mass(blk, m, i, jw, rev1, rev2)
    # the reference gear does not scale its impulse by dtRatio
    # (b2GearJoint.cpp:210-224)
    imp = blk.impulse if warm else torch.zeros_like(blk.impulse)

    def signed(x):
        return torch.cat([x[..., :2], -x[..., 2:]], -1)

    return (GearData(active, body, m, i, signed(m), signed(i), lc, jv_ac, jv_bd, jw,
                     _inv(mass_raw, mass_raw > 0.0)),
            {"impulse": imp})


def _gear_apply(d, j, lin, ang, imp, jv_ac, jv_bd, jw):
    """lin (W,N,2), ang (W,N) plus gear slot j's impulse `imp` (W,) on its
    four bodies; jv_ac, jv_bd (W,2) and jw (W,4) are the slot's Jacobian."""
    m, i = d.m_signed[:, j], d.i_signed[:, j]
    jv = torch.stack([jv_ac, jv_bd, jv_ac, jv_bd], 1)                 # (W,4,2)
    rows = torch.cat([(m * imp[:, None])[..., None] * jv,
                      ((i * imp[:, None]) * jw)[..., None]], -1)
    out = add_rows(torch.cat([lin, ang[..., None]], -1), d.body[:, j], rows)
    return out[..., 0:2], out[..., 2]


def _gear_warm(d, st, v, w):
    for j in range(d.active.shape[1]):
        imp = torch.where(d.active[:, j], st["impulse"][:, j], 0.0)
        v, w = _gear_apply(d, j, v, w, imp, d.jv_ac[:, j], d.jv_bd[:, j], d.jw[:, j])
    return v, w


def _gear_velocity(d, st, v, w):
    """Slot-order velocity pass (b2GearJoint.cpp:236-270)."""
    imps = []
    for j in range(d.active.shape[1]):
        vb, wb = take(v, d.body[:, j]), take(w, d.body[:, j])     # (W,4,2), (W,4)
        jw = d.jw[:, j]
        cdot = (dot(d.jv_ac[:, j], vb[:, 0] - vb[:, 2])
                + dot(d.jv_bd[:, j], vb[:, 1] - vb[:, 3])
                + (jw[:, 0] * wb[:, 0] - jw[:, 2] * wb[:, 2])
                + (jw[:, 1] * wb[:, 1] - jw[:, 3] * wb[:, 3]))
        imp = torch.where(d.active[:, j], -d.mass[:, j] * cdot, 0.0)
        imps.append(imp)
        v, w = _gear_apply(d, j, v, w, imp, d.jv_ac[:, j], d.jv_bd[:, j], jw)
    return {**st, "impulse": st["impulse"] + torch.stack(imps, 1)}, v, w


def _gear_position(blk, d, c, a):
    """Slot-order NGS pass (b2GearJoint.cpp:272-369). It reports no
    convergence flag, as in the JAX package."""
    for j in range(d.active.shape[1]):
        sl = _slot(blk, j)
        cb = take(c, d.body[:, j])[:, None]                   # (W,1,4,2)
        ab = take(a, d.body[:, j])[:, None]                   # (W,1,4)
        lc = d.lc[:, j:j + 1]
        jv_ac, jv_bd, jw, rev1, rev2, r_a, r_b = _gear_jacobian(sl, lc, ab)
        mass = _gear_mass(sl, d.m[:, j:j + 1], d.i[:, j:j + 1], jw, rev1, rev2)
        # the coupled joints' coordinates at the current positions
        # (b2GearJoint.cpp:300, 314, 324, 338)
        pc1 = sl.local_anchor_c - lc[..., 2, :]
        pa1 = rot_t_vec(rot_from_angle(ab[..., 2]), r_a + (cb[..., 0, :] - cb[..., 2, :]))
        coord_a = torch.where(rev1, ab[..., 0] - ab[..., 2] - sl.reference_angle_a,
                              dot(pa1 - pc1, sl.local_axis_c))
        pd2 = sl.local_anchor_d - lc[..., 3, :]
        pb2 = rot_t_vec(rot_from_angle(ab[..., 3]), r_b + (cb[..., 1, :] - cb[..., 3, :]))
        coord_b = torch.where(rev2, ab[..., 1] - ab[..., 3] - sl.reference_angle_b,
                              dot(pb2 - pd2, sl.local_axis_d))
        cc = (coord_a + sl.ratio * coord_b) - sl.constant
        imp = torch.where(d.active[:, j:j + 1] & (mass > 0.0),
                          -cc / torch.where(mass > 0.0, mass, 1.0), 0.0)
        c, a = _gear_apply(d, j, c, a, imp[:, 0], jv_ac[:, 0], jv_bd[:, 0], jw[:, 0])
    return c, a


def _slot(blk, j):
    """Slot j of a block, as a block of one slot."""
    return type(blk)(**{f.name: getattr(blk, f.name)[:, j:j + 1]
                        for f in dataclasses.fields(blk)})


# ==========================================================================
# registry / dispatcher
# ==========================================================================

# the JAX package's solve order of the colored types; the gear runs after
# them
_SOLVE_ORDER = ("revolute", "distance", "prismatic", "mouse", "weld",
                "friction", "rope", "motor", "wheel", "pulley")
_INIT = {"revolute": _revolute_init, "distance": _distance_init,
         "prismatic": _prismatic_init, "mouse": _mouse_init, "weld": _weld_init,
         "friction": _friction_init, "rope": _rope_init, "motor": _motor_init,
         "wheel": _wheel_init, "pulley": _pulley_init}
_INIT_TAKES_DT = ("distance", "mouse", "weld", "wheel")
_WARM = {"revolute": _revolute_warm, "distance": _distance_warm,
         "prismatic": _prismatic_warm, "mouse": _mouse_warm, "weld": _weld_warm,
         "friction": _friction_warm, "rope": _distance_warm,
         "motor": _friction_warm, "wheel": _wheel_warm, "pulley": _pulley_warm}
_VELOCITY = {"revolute": _revolute_velocity, "distance": _distance_velocity,
             "prismatic": _prismatic_velocity, "mouse": _mouse_velocity,
             "weld": _weld_velocity, "friction": _friction_velocity,
             "rope": _rope_velocity, "motor": _motor_velocity,
             "wheel": _wheel_velocity, "pulley": _pulley_velocity}
_POSITION = {"revolute": _revolute_position, "distance": _distance_position,
             "prismatic": _prismatic_position, "mouse": _no_position,
             "weld": _weld_position, "friction": _no_position,
             "rope": _rope_position, "motor": _no_position,
             "wheel": _wheel_position, "pulley": _pulley_position}
# what each type persists in its block
_STORED = {"revolute": ("impulse", "motor_impulse", "limit_state"),
           "distance": ("impulse",),
           "prismatic": ("impulse", "motor_impulse", "limit_state"),
           "mouse": ("impulse",),
           "weld": ("impulse",),
           "friction": ("linear_impulse", "angular_impulse"),
           "rope": ("impulse",),
           "motor": ("linear_impulse", "angular_impulse"),
           "wheel": ("impulse", "spring_impulse", "motor_impulse"),
           "pulley": ("impulse",),
           "gear": ("impulse",)}


class JointData(NamedTuple):
    """Per-step joint data: {name: (block, data)} of the colored types in
    solve order, the number of joint colors in use over the batch, {name:
    colors its joints use over the batch} (the type's largest color + 1),
    and the gear's (block, data) or None."""
    blocks: dict
    n_colors: int
    used: dict
    gear: tuple = None


def init_joints(joints, bodies, awake, v, w, dt, dt_ratio, warm_starting,
                nb, max_colors, syncs: HostSyncs = None):
    """Color all joints but the gears jointly and init the per-type data.
    `dt_ratio` is (W,). Returns (JointData, state): state maps a block
    name to its impulses and limit states. The color count is one host
    read, and so is each round of the coloring where it runs `_luby` (on
    the CPU; a card colors in one launch of K7), counted in `syncs`."""
    from . import blocks as joint_blocks
    syncs = syncs or HostSyncs()
    bl = [(n, b) for n, b in joint_blocks(joints) if n != "gear"]
    data, state, n_colors, gear, used = {}, {}, 0, None, {}
    if bl:
        ba = torch.cat([b.body_a for _, b in bl], 1).clamp_min(0).long()
        bb = torch.cat([b.body_b for _, b in bl], 1).clamp_min(0).long()
        act = torch.cat([b.active for _, b in bl], 1)
        dyn = bodies.is_dynamic
        col, _ = coloring.color_constraints(ba, bb, take(dyn, ba), take(dyn, bb),
                                            act, nb, max_colors, syncs=syncs)
        sizes = [b.body_a.shape[1] for _, b in bl]
        colors = dict(zip((n for n, _ in bl), torch.split(col, sizes, 1)))
        tops = syncs.values(torch.stack([c.max() for c in colors.values()]))
        used = {n: top + 1 for n, top in zip(colors, tops)}
        n_colors = max(used.values())
        for name in _SOLVE_ORDER:
            if name not in colors:
                continue
            blk = getattr(joints, name)
            extra = (dt,) if name in _INIT_TAKES_DT else ()
            d, s = _INIT[name](blk, bodies, awake, colors[name], dt_ratio,
                               warm_starting, *extra)
            data[name] = (blk, d)
            state[name] = s
    if joints.gear.body_a.shape[-1] > 0:
        d, state["gear"] = _gear_init(joints.gear, bodies, awake, warm_starting)
        gear = (joints.gear, d)
    return JointData(data, n_colors, used, gear), state


def warm_start_joints(jdata: JointData, jstate, v, w):
    for name, (_, d) in jdata.blocks.items():
        v, w = _WARM[name](d, jstate[name], v, w)
    if jdata.gear is not None:
        v, w = _gear_warm(jdata.gear[1], jstate["gear"], v, w)
    return v, w


def solve_joint_velocity(jdata: JointData, jstate, v, w, dt):
    """One velocity iteration over all joints: color by color, then the
    gears in slot order."""
    for ci in range(jdata.n_colors):
        for name, (blk, d) in jdata.blocks.items():
            if ci >= jdata.used[name]:
                continue
            st, v, w = _VELOCITY[name](blk, d, jstate[name], v, w, dt,
                                       d.com.color == ci)
            jstate = {**jstate, name: st}
    if jdata.gear is not None:
        st, v, w = _gear_velocity(jdata.gear[1], jstate["gear"], v, w)
        jstate = {**jstate, "gear": st}
    return jstate, v, w


def solve_joint_position(jdata: JointData, jstate, c, a):
    """One NGS iteration over all joints, the gears last. Returns (c, a,
    ok_body): a body is not ok when a colored joint on it is still outside
    its tolerances."""
    nw, nb = a.shape
    ok_body = torch.ones((nw, nb + 1), dtype=torch.bool, device=a.device)
    for ci in range(jdata.n_colors):
        for name, (blk, d) in jdata.blocks.items():
            if ci >= jdata.used[name]:
                continue
            on = d.com.color == ci
            c, a, ok = _POSITION[name](blk, d, jstate[name], c, a, on)
            bad = ~ok & on
            ok_body.scatter_(1, torch.cat([torch.where(bad, d.com.body_a, nb),
                                           torch.where(bad, d.com.body_b, nb)], 1),
                             False)
    if jdata.gear is not None:
        c, a = _gear_position(*jdata.gear, c, a)
    return c, a, ok_body[:, :nb]


def store_joint_impulses(joints, jstate):
    """Persist impulses and limit states back into the typed blocks."""
    return dataclasses.replace(joints, **{
        name: dataclasses.replace(getattr(joints, name),
                                  **{k: s[k] for k in _STORED[name]})
        for name, s in jstate.items()})
