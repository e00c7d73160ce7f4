"""Standalone position-based-dynamics rope (reference: Rope/b2Rope.cpp),
batched over ropes.

Port of `box2d_mt_tpu.rope`. Not world-integrated, exactly like the
reference: a rope is its own little simulation with stretch (C2) and
bending (C3) constraints solved by sequential Gauss-Seidel. The sweeps
are order-dependent, so they visit the vertices in the reference's
order, as a Python loop over vertices of (R,)-wide tensor operations: R
ropes step together, each with its own stiffness, damping and gravity.

API:
    ropes = make_rope(vertices, masses, gravity, damping=0., k2=1., k3=0.1)
    ropes = replicate(ropes, 1024)               # R identical ropes
    ropes = rope_step(ropes, h, iterations)
    ropes = set_angle(ropes, angle)              # b2Rope::SetAngle
"""

from typing import NamedTuple

import numpy as np
import torch

PI = 3.14159265358979323846


class RopeState(NamedTuple):
    """b2Rope's arrays (b2Rope.h:63-114), each with a leading rope axis R."""
    ps: torch.Tensor        # (R, N, 2) positions
    vs: torch.Tensor        # (R, N, 2) velocities
    ims: torch.Tensor       # (R, N) inverse masses
    lengths: torch.Tensor   # (R, N-1) rest lengths
    angles: torch.Tensor    # (R, N-2) rest joint angles
    gravity: torch.Tensor   # (R, 2)
    damping: torch.Tensor   # (R,)
    k2: torch.Tensor        # (R,) stretch stiffness
    k3: torch.Tensor        # (R,) bend stiffness


def make_rope(vertices, masses, gravity=(0.0, -10.0), damping=0.0, k2=1.0, k3=0.1,
              device="cuda") -> RopeState:
    """b2Rope::Initialize (b2Rope.cpp:46-103): a batch of one rope on
    `device` (the card unless the caller asks for another)."""
    ps = np.asarray(vertices, np.float32)
    m = np.asarray(masses, np.float32)
    if ps.shape[0] < 3:
        raise ValueError("a rope needs at least 3 vertices (b2Rope::Initialize)")
    ims = np.where(m > 0.0, 1.0 / np.where(m > 0.0, m, 1.0), 0.0)
    d = ps[1:] - ps[:-1]
    lengths = np.sqrt((d ** 2).sum(-1))
    d1, d2 = d[:-1], d[1:]
    angles = np.arctan2(d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0], (d1 * d2).sum(-1))

    def t(x):
        return torch.from_numpy(np.asarray(x, np.float32)[None]).to(device)

    return RopeState(ps=t(ps), vs=t(np.zeros_like(ps)), ims=t(ims), lengths=t(lengths),
                     angles=t(angles), gravity=t(gravity), damping=t(damping),
                     k2=t(k2), k3=t(k3))


def replicate(state: RopeState, n: int) -> RopeState:
    """The batch of ropes tiled n times along the rope axis."""
    return RopeState(*(x.repeat((n,) + (1,) * (x.dim() - 1)).contiguous() for x in state))


def set_angle(state: RopeState, angle) -> RopeState:
    """b2Rope::SetAngle (b2Rope.cpp:171-178)."""
    return state._replace(angles=torch.full_like(state.angles, float(np.float32(angle))))


def _solve_c2(ps, ims, lengths, k2):
    """Stretch constraints, segment by segment (b2Rope::SolveC2,
    b2Rope.cpp:140-168). ps: a list of (R, 2) vertex positions, updated."""
    for i in range(len(ps) - 1):
        p1, p2 = ps[i], ps[i + 1]
        d = p2 - p1
        length = torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])
        dn = d / torch.where(length > 0.0, length, 1.0)[:, None]
        im1, im2 = ims[:, i], ims[:, i + 1]
        s = im1 + im2
        ok = (s != 0.0)[:, None]
        inv = 1.0 / torch.where(s != 0.0, s, 1.0)
        corr = k2 * (lengths[:, i] - length)
        ps[i] = torch.where(ok, p1 - ((im1 * inv) * corr)[:, None] * dn, p1)
        ps[i + 1] = torch.where(ok, p2 + ((im2 * inv) * corr)[:, None] * dn, p2)


def _solve_c3(ps, ims, angles, k3):
    """Bending constraints, joint by joint (b2Rope::SolveC3,
    b2Rope.cpp:180-249)."""
    for i in range(len(ps) - 2):
        p1, p2, p3 = ps[i], ps[i + 1], ps[i + 2]
        m1, m2, m3 = ims[:, i], ims[:, i + 1], ims[:, i + 2]
        d1 = p2 - p1
        d2 = p3 - p2
        l1 = d1[:, 0] * d1[:, 0] + d1[:, 1] * d1[:, 1]
        l2 = d2[:, 0] * d2[:, 0] + d2[:, 1] * d2[:, 1]
        ok = l1 * l2 != 0.0
        a = d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]
        b = d1[:, 0] * d2[:, 0] + d1[:, 1] * d2[:, 1]
        angle = torch.atan2(a, b)
        jd1 = (-1.0 / torch.where(l1 != 0.0, l1, 1.0))[:, None] * torch.stack(
            [-d1[:, 1], d1[:, 0]], -1)
        jd2 = (1.0 / torch.where(l2 != 0.0, l2, 1.0))[:, None] * torch.stack(
            [-d2[:, 1], d2[:, 0]], -1)
        j1 = -jd1
        j2 = jd1 - jd2
        j3 = jd2
        sq = lambda j: j[:, 0] * j[:, 0] + j[:, 1] * j[:, 1]
        mass = m1 * sq(j1) + m2 * sq(j2) + m3 * sq(j3)
        ok = (ok & (mass != 0.0))[:, None]
        inv_mass = 1.0 / torch.where(mass != 0.0, mass, 1.0)
        # wrap C into (-pi, pi] (the reference's while loops)
        c = angle - angles[:, i]
        c = c - 2.0 * PI * torch.floor((c + PI) / (2.0 * PI))
        impulse = -k3 * inv_mass * c
        ps[i] = torch.where(ok, p1 + (m1 * impulse)[:, None] * j1, p1)
        ps[i + 1] = torch.where(ok, p2 + (m2 * impulse)[:, None] * j2, p2)
        ps[i + 2] = torch.where(ok, p3 + (m3 * impulse)[:, None] * j3, p3)


def rope_step(state: RopeState, h, iterations: int = 1) -> RopeState:
    """b2Rope::Step (b2Rope.cpp:105-138) of every rope: integrate, iterate
    C2/C3/C2, derive the velocities from the position deltas. h == 0 is a
    no-op (b2Rope.cpp:107-110)."""
    h = float(np.float32(h))
    if h == 0.0:
        return state
    d = torch.exp(-h * state.damping)[:, None, None]
    movable = (state.ims > 0.0)[..., None]
    vs = torch.where(movable, state.vs + h * state.gravity[:, None], state.vs)
    vs = vs * d
    ps = state.ps + h * vs
    pts = list(ps.unbind(1))
    for _ in range(iterations):
        _solve_c2(pts, state.ims, state.lengths, state.k2)
        _solve_c3(pts, state.ims, state.angles, state.k3)
        _solve_c2(pts, state.ims, state.lengths, state.k2)
    ps_new = torch.stack(pts, 1)
    return state._replace(ps=ps_new, vs=float(np.float32(1.0) / np.float32(h))
                          * (ps_new - state.ps))
