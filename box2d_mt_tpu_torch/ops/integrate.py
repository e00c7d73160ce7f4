"""Velocity/position integration (b2Island::Solve integration blocks,
b2Island.cpp:192-230 and :283-313), batched over worlds.

`dt` is a Python float that is exactly a float32 value (the step converts
it once), so tensor-scalar products round like the JAX package's f32
scalar; products of two scalars are formed in float32 explicitly."""

import numpy as np
import torch

from .. import settings


def integrate_velocities(bodies, gravity, dt: float, solve_mask):
    """Semi-implicit Euler + Padé damping for awake dynamic bodies.
    bodies leaves (W, N...), gravity (W, 2), solve_mask (W, N)."""
    dyn = solve_mask & bodies.is_dynamic
    v = bodies.v + dt * (bodies.gravity_scale[..., None] * gravity[:, None, :]
                         + bodies.inv_mass[..., None] * bodies.force)
    w = bodies.w + dt * bodies.inv_inertia * bodies.torque
    v = v * (1.0 / (1.0 + dt * bodies.linear_damping))[..., None]
    w = w * (1.0 / (1.0 + dt * bodies.angular_damping))
    v = torch.where(dyn[..., None], v, bodies.v)
    w = torch.where(dyn, w, bodies.w)
    return v, w


def integrate_positions(c, a, v, w, dt: float, move_mask):
    """Integrate with translation/rotation clamps; returns (c, a, v, w) —
    the reference clamps *velocities* when the step would exceed the
    limits (b2Island.cpp:290-303)."""
    dt2 = float(np.float32(dt) * np.float32(dt))
    translation2 = dt2 * (v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1])
    tlen = torch.sqrt(torch.clamp_min(translation2, 1e-30))
    ratio_t = torch.where(translation2 > settings.MAX_TRANSLATION_SQUARED,
                          settings.MAX_TRANSLATION / tlen, 1.0)
    v = v * ratio_t[..., None]
    rotation = dt * w
    safe = torch.where(rotation == 0.0, 1.0, rotation)
    ratio_r = torch.where(rotation * rotation > settings.MAX_ROTATION_SQUARED,
                          settings.MAX_ROTATION / torch.abs(safe), 1.0)
    w = w * ratio_r
    c = torch.where(move_mask[..., None], c + dt * v, c)
    a = torch.where(move_mask, a + dt * w, a)
    return c, a, v, w
