"""Batched joint constraint solvers.

Port of `box2d_mt_tpu.joints.solver` for four joint types (revolute,
distance, prismatic, weld; reference: Box2D/Dynamics/Joints/b2*Joint.cpp),
written over a leading world axis where the JAX package vmaps a per-world
function: blocks and per-joint data are (W, J...), body state is v (W, N,
2), w (W, N), c (W, N, 2), a (W, N). Every expression keeps the JAX
package's order of floating-point operations.

All types share one coloring pass (joints conflict through shared dynamic
bodies exactly like contacts); within a color every type's masked pass
adds its deltas to disjoint dynamic bodies. Static endpoints are shared,
and receive exact zeros from every lane, so the deltas are summed into
zeros and then added (`math2d.add_rows`), never assigned through an index.

Limit states (e_inactiveLimit/e_atLower/e_atUpper/e_equalLimits,
b2Joint.h:77-84) persist across steps in the joint block and gate impulse
resets at init, matching the reference's hysteresis.

The color passes loop over the colors in use (one host read in
`init_joints`) where the JAX package runs a masked loop over `max_colors`:
a pass of an unused color changes nothing.
"""

import dataclasses
import math
from typing import NamedTuple

import torch

from .. import settings
from ..math2d import add_rows, cross_sv, cross_vv, dot, rot_from_angle, rot_vec, take
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
# registry / dispatcher
# ==========================================================================

# the JAX package's solve order; the types not ported yet take their place
# here when they come
_SOLVE_ORDER = ("revolute", "distance", "prismatic", "mouse", "weld",
                "friction", "rope", "motor", "wheel", "pulley")
_INIT = {"revolute": _revolute_init, "distance": _distance_init,
         "prismatic": _prismatic_init, "weld": _weld_init}
_INIT_TAKES_DT = ("distance", "weld")
_WARM = {"revolute": _revolute_warm, "distance": _distance_warm,
         "prismatic": _prismatic_warm, "weld": _weld_warm}
_VELOCITY = {"revolute": _revolute_velocity, "distance": _distance_velocity,
             "prismatic": _prismatic_velocity, "weld": _weld_velocity}
_POSITION = {"revolute": _revolute_position, "distance": _distance_position,
             "prismatic": _prismatic_position, "weld": _weld_position}
# what each type persists in its block
_STORED = {"revolute": ("impulse", "motor_impulse", "limit_state"),
           "distance": ("impulse",),
           "prismatic": ("impulse", "motor_impulse", "limit_state"),
           "weld": ("impulse",)}


class JointData(NamedTuple):
    """Per-step joint data: {name: (block, data)} in solve order, and the
    number of joint colors in use over the batch."""
    blocks: dict
    n_colors: int


def init_joints(joints, bodies, awake, v, w, dt, dt_ratio, warm_starting,
                nb, max_colors, syncs: HostSyncs = None):
    """Color all joints jointly and init the per-type data. `dt_ratio` is
    (W,). Returns (JointData, state): state maps a block name to its
    impulses and limit states. The coloring's rounds and the color count
    are host reads, counted in `syncs`."""
    from . import blocks as joint_blocks
    syncs = syncs or HostSyncs()
    bl = joint_blocks(joints)
    if not bl:
        return JointData({}, 0), {}
    ba = torch.cat([b.body_a for _, b in bl], 1).clamp_min(0).long()
    bb = torch.cat([b.body_b for _, b in bl], 1).clamp_min(0).long()
    act = torch.cat([b.active for _, b in bl], 1)
    dyn = bodies.is_dynamic
    col, _ = coloring.color_constraints(ba, bb, take(dyn, ba), take(dyn, bb),
                                        act, nb, max_colors, syncs=syncs)
    n_colors = syncs.value(col.max()) + 1
    sizes = [b.body_a.shape[1] for _, b in bl]
    colors = dict(zip((n for n, _ in bl), torch.split(col, sizes, 1)))

    data, state = {}, {}
    for name in _SOLVE_ORDER:
        if name not in colors:
            continue
        blk = getattr(joints, name)
        extra = (dt,) if name in _INIT_TAKES_DT else ()
        d, s = _INIT[name](blk, bodies, awake, colors[name], dt_ratio,
                           warm_starting, *extra)
        data[name] = (blk, d)
        state[name] = s
    return JointData(data, n_colors), state


def warm_start_joints(jdata: JointData, jstate, v, w):
    for name, (_, d) in jdata.blocks.items():
        v, w = _WARM[name](d, jstate[name], v, w)
    return v, w


def solve_joint_velocity(jdata: JointData, jstate, v, w, dt):
    """One velocity iteration over all joints, color by color."""
    for ci in range(jdata.n_colors):
        for name, (blk, d) in jdata.blocks.items():
            st, v, w = _VELOCITY[name](blk, d, jstate[name], v, w, dt,
                                       d.com.color == ci)
            jstate = {**jstate, name: st}
    return jstate, v, w


def solve_joint_position(jdata: JointData, jstate, c, a):
    """One NGS iteration over all joints. Returns (c, a, ok_body): a body
    is not ok when a joint on it is still outside its tolerances."""
    nw, nb = a.shape
    ok_body = torch.ones((nw, nb + 1), dtype=torch.bool, device=a.device)
    for ci in range(jdata.n_colors):
        for name, (blk, d) in jdata.blocks.items():
            on = d.com.color == ci
            c, a, ok = _POSITION[name](blk, d, jstate[name], c, a, on)
            bad = ~ok & on
            ok_body.scatter_(1, torch.cat([torch.where(bad, d.com.body_a, nb),
                                           torch.where(bad, d.com.body_b, nb)], 1),
                             False)
    return c, a, ok_body[:, :nb]


def store_joint_impulses(joints, jstate):
    """Persist impulses and limit states back into the typed blocks."""
    return dataclasses.replace(joints, **{
        name: dataclasses.replace(getattr(joints, name),
                                  **{k: s[k] for k in _STORED[name]})
        for name, s in jstate.items()})
