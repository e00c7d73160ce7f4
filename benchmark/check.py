"""The comparison that decides `correct`.

The window's answers are its steps. After the window, the check takes the
episode that a seeded draw kept (every completed episode equally likely)
and holds the program to the plain reference (`reference/`, Box2D 2.3.1's
semantics written anew) in two parts:

  * the start: the worlds the program's `WorldBuilder` built for the run
    against those the reference's builder made from the same body lists
    (`start_gap`: poses, velocities, masses and friction; a body's type,
    a fixture's body or an awake flag that differs is an infinite gap);
  * each step of the kept stretch of that episode, from the program's
    state before it (`Reference.follow`): `position_gap_m`, the largest
    distance by which a point of a body lies off the reference's (from
    its center and its angle); `velocity_gap_mps`, the same of
    velocities; `impulse_gap_Ns`, the widest gap of a stored contact
    impulse, matched by (pair, feature key); `awake_mismatches`, bodies
    whose awake flag differs. A body that the program's TOI phase moved
    is left out of its step (the reference does not step that phase).

A number that is not finite fails its limit."""

import math

import torch

from .reference import geometry as g
from .reference.step import RefState

NUMBERS = ("start_gap", "position_gap_m", "velocity_gap_mps", "impulse_gap_Ns",
           "awake_mismatches")


def start_gap(program_pool, reference_pool: RefState) -> float:
    st = reference_pool.structure
    nb, nf = st.body_type.numel(), st.fix_body.numel()
    rb = reference_pool.bodies
    if isinstance(program_pool, RefState):
        pb, inv_m, inv_i, fric = program_pool.bodies, None, None, None
    else:
        b, fx = program_pool.bodies, program_pool.fixtures
        if not (torch.equal(b.body_type[:, :nb].long(), st.body_type[None].expand(b.c.shape[0], -1))
                and bool((b.body_type[:, nb:] < 0).all())
                and torch.equal(fx.body[:, :nf].long(), st.fix_body[None].expand(b.c.shape[0], -1))
                and bool((fx.body[:, nf:] < 0).all())):
            return math.inf
        pb = b
        inv_m, inv_i, fric = b.inv_mass[:, :nb], b.inv_inertia[:, :nb], fx.friction[:, :nf]
    dyn = st.body_type == g.DYNAMIC
    if not torch.equal(pb.awake[:, :nb][:, dyn], rb.awake[:, dyn]):
        return math.inf
    f = lambda x: x[:, :nb].double()
    rad = st.rmax[None].double()
    gaps = [(f(pb.c) - rb.c.double()).abs().amax(-1) + (f(pb.a) - rb.a.double()).abs() * rad,
            (f(pb.v) - rb.v.double()).abs().amax(-1) + (f(pb.w) - rb.w.double()).abs() * rad]
    if inv_m is not None:
        gaps += [_rel(inv_m.double(), st.inv_mass[None].double()),
                 _rel(inv_i.double(), st.inv_inertia[None].double()),
                 (fric.double() - st.friction[None].double()).abs()]
    return max(_finite_max(x) for x in gaps)


def _rel(x, ref):
    return (x - ref).abs() / torch.clamp_min(ref.abs(), 1e-30)


def _finite_max(x) -> float:
    if not bool(x.isfinite().all()):
        return math.inf
    return float(x.max()) if x.numel() else 0.0


def judge(values: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number within its
    limit; a number without a value (nothing to compare) fails."""
    out, ok = {}, True
    for name in NUMBERS:
        v, lim = values.get(name), limits[name]
        good = v is not None and math.isfinite(v) and v <= lim
        ok = ok and good
        out[name] = {"value": _json_number(v), "limit": lim}
    return ok, out


def _json_number(v):
    if v is None:
        return None
    return v if math.isfinite(v) else str(v)
