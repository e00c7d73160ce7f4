"""Functional between-step mutations over a batch of worlds: the
b2Body/b2World setter API (reference: b2Body.h:139-430) as pure
State -> State transforms.

Port of `box2d_mt_tpu.mutate`, with its names and defaults. Every
function returns a new State and writes into no tensor of the one it is
given, and everything stays on the state's device.

Batched indices: a body, fixture, joint or contact-fixture index is a
Python int (the same slot in every world) or a (W,) integer tensor with
one slot per world, in which -1 leaves that world as it is. Values
(positions, velocities, flags, ...) are one value for every world or a
tensor with a leading world axis. `add_body`, `add_fixture` and the
`add_*_joint` functions return `(state, index)` with a (W,) int32 index
on the state's device, -1 where a world is full (or was left alone).
`pairs_dirty` is set in the worlds a function touches, where the JAX
package sets it.
"""

import dataclasses
import math

import numpy as np
import torch

from . import settings, shapes
from .math2d import body_xf, cross_sv, rot_from_angle, rot_vec, take
from .ops import broadphase
from .state import JOINT_BLOCKS, State


# --------------------------------------------------------------------------
# batched index and value helpers
# --------------------------------------------------------------------------


def _idx(state: State, index):
    """(slot (W,) long clamped to >= 0, on (W,) bool) of a batched index."""
    nw, dev = state.n_worlds, state.gravity.device
    if torch.is_tensor(index):
        i = index.to(device=dev, dtype=torch.long)
        if i.dim() == 0:
            i = i.expand(nw)
        if i.shape != (nw,):
            raise ValueError(f"a batched index is an int or a ({nw},) tensor, "
                             f"got shape {tuple(i.shape)}")
    else:
        i = torch.full((nw,), int(index), dtype=torch.long, device=dev)
    return i.clamp_min(0), i >= 0


def _vals(state: State, value, tail, dtype):
    """`value` as a (W,) + tail tensor: one value for every world, or a
    tensor with a leading world axis."""
    nw, dev = state.n_worlds, state.gravity.device
    t = torch.as_tensor(value, dtype=dtype, device=dev) if not torch.is_tensor(value) \
        else value.to(device=dev, dtype=dtype)
    if t.dim() == len(tail):
        t = t.expand((nw,) + tuple(tail))
    if tuple(t.shape) != (nw,) + tuple(tail):
        raise ValueError(f"a value of shape {tuple(tail)} or {(nw,) + tuple(tail)} "
                         f"was expected, got {tuple(t.shape)}")
    return t


def _rows(arr, i, on):
    """(W, N) bool: slot i of every world where on."""
    return (torch.arange(arr.shape[1], device=arr.device) == i[:, None]) & on[:, None]


def _bc(mask, arr):
    return mask.reshape(mask.shape + (1,) * (arr.dim() - mask.dim()))


def _put(arr, i, on, value):
    """arr with slot i of each world `on` set to value ((W,) + row)."""
    v = value.to(arr.dtype)[:, None]
    return torch.where(_bc(_rows(arr, i, on), arr), v, arr)


def _add(arr, i, on, value):
    """arr with value ((W,) + row) added at slot i of each world `on`."""
    v = value.to(arr.dtype)[:, None]
    return arr + torch.where(_bc(_rows(arr, i, on), arr), v, torch.zeros_like(v))


def _row(arr, i):
    """arr[w, i[w]] (W, ...)."""
    return take(arr, i[:, None])[:, 0]


def _set(state: State, group: str, i, on, **values):
    """Set one slot per world of several fields of a group."""
    g = getattr(state, group)
    upd = {k: _put(getattr(g, k), i, on,
                   _vals(state, v, getattr(g, k).shape[2:], getattr(g, k).dtype))
           for k, v in values.items()}
    return dataclasses.replace(state, **{group: dataclasses.replace(g, **upd)})


def _dirty(state: State, on) -> State:
    return dataclasses.replace(state, pairs_dirty=state.pairs_dirty | on)


def _upd_bodies(state, **kw):
    return dataclasses.replace(state, bodies=dataclasses.replace(state.bodies, **kw))


# --------------------------------------------------------------------------
# body setters
# --------------------------------------------------------------------------


def set_transform(state: State, body, position, angle) -> State:
    """b2Body::SetTransform: origin position + angle; recomputes the sweep
    center and resets the sweep start. Does NOT wake the body (reference
    behavior)."""
    i, on = _idx(state, body)
    b = state.bodies
    position = _vals(state, position, (2,), torch.float32)
    angle = _vals(state, angle, (), torch.float32)
    c = position + rot_vec(rot_from_angle(angle), _row(b.local_center, i))
    state = _upd_bodies(state, c=_put(b.c, i, on, c), a=_put(b.a, i, on, angle),
                        c0=_put(b.c0, i, on, c), a0=_put(b.a0, i, on, angle))
    return _resync_fixtures(state, body)


def _resync_fixtures(state: State, body) -> State:
    """Refresh the fat AABBs of the moved body's fixtures so that the next
    step's pair pass sees the teleport (b2Body::SetTransform synchronizes
    its proxies)."""
    i, on = _idx(state, body)
    fx = state.fixtures
    bset = (fx.body == i[:, None]) & on[:, None]
    p, q = body_xf(state.bodies.c, state.bodies.a, state.bodies.local_center)
    fb = fx.body.clamp_min(0).long()
    lo, hi = broadphase.tight_aabbs(fx, take(p, fb), take(q, fb))
    lo = lo - settings.AABB_EXTENSION
    hi = hi + settings.AABB_EXTENSION
    return dataclasses.replace(state, fixtures=dataclasses.replace(
        fx, aabb_lo=torch.where(bset[..., None], lo, fx.aabb_lo),
        aabb_hi=torch.where(bset[..., None], hi, fx.aabb_hi)))


def set_linear_velocity(state: State, body, v) -> State:
    i, on = _idx(state, body)
    return _set(state, "bodies", i, on, v=v, awake=True)


def set_angular_velocity(state: State, body, w) -> State:
    i, on = _idx(state, body)
    return _set(state, "bodies", i, on, w=w, awake=True)


def apply_force(state: State, body, force, point=None, wake=True) -> State:
    """b2Body::ApplyForce / ApplyForceToCenter."""
    i, on = _idx(state, body)
    b = state.bodies
    force = _vals(state, force, (2,), torch.float32)
    kw = dict(force=_add(b.force, i, on, force))
    if point is not None:
        r = _vals(state, point, (2,), torch.float32) - _row(b.c, i)
        kw["torque"] = _add(b.torque, i, on, r[..., 0] * force[..., 1]
                            - r[..., 1] * force[..., 0])
    if wake:
        kw["awake"] = _put(b.awake, i, on, _vals(state, True, (), torch.bool))
    return _upd_bodies(state, **kw)


def apply_torque(state: State, body, torque, wake=True) -> State:
    i, on = _idx(state, body)
    b = state.bodies
    kw = dict(torque=_add(b.torque, i, on, _vals(state, torque, (), torch.float32)))
    if wake:
        kw["awake"] = _put(b.awake, i, on, _vals(state, True, (), torch.bool))
    return _upd_bodies(state, **kw)


def apply_linear_impulse(state: State, body, impulse, point, wake=True) -> State:
    """b2Body::ApplyLinearImpulse."""
    i, on = _idx(state, body)
    b = state.bodies
    impulse = _vals(state, impulse, (2,), torch.float32)
    r = _vals(state, point, (2,), torch.float32) - _row(b.c, i)
    kw = dict(v=_add(b.v, i, on, _row(b.inv_mass, i)[:, None] * impulse),
              w=_add(b.w, i, on, _row(b.inv_inertia, i)
                     * (r[..., 0] * impulse[..., 1] - r[..., 1] * impulse[..., 0])))
    if wake:
        kw["awake"] = _put(b.awake, i, on, _vals(state, True, (), torch.bool))
    return _upd_bodies(state, **kw)


def apply_angular_impulse(state: State, body, impulse, wake=True) -> State:
    i, on = _idx(state, body)
    b = state.bodies
    kw = dict(w=_add(b.w, i, on, _row(b.inv_inertia, i)
                     * _vals(state, impulse, (), torch.float32)))
    if wake:
        kw["awake"] = _put(b.awake, i, on, _vals(state, True, (), torch.bool))
    return _upd_bodies(state, **kw)


def set_type(state: State, body, body_type) -> State:
    """b2Body::SetType (b2Body.cpp): change static/kinematic/dynamic;
    resets mass data, zeroes velocity for static, wakes the body, and
    dirties the pair table (contact filtering depends on types)."""
    i, on = _idx(state, body)
    b = state.bodies
    body_type = _vals(state, body_type, (), torch.int32)
    static = body_type == settings.STATIC_BODY
    state = _set(state, "bodies", i, on, body_type=body_type,
                 v=torch.where(static[:, None], 0.0, _row(b.v, i)),
                 w=torch.where(static, 0.0, _row(b.w, i)),
                 c0=_row(b.c, i), a0=_row(b.a, i), awake=True, sleep_time=0.0)
    return _reset_mass_data(_dirty(state, on), body)


def set_bullet(state: State, body, flag) -> State:
    """b2Body::SetBullet: toggles CCD candidacy (evaluated per step)."""
    i, on = _idx(state, body)
    return _set(state, "bodies", i, on, bullet=flag)


def set_enabled(state: State, body, flag) -> State:
    """b2Body::SetActive analog: enabled bodies collide; disabling drops the
    body's contacts at the next pair refresh."""
    i, on = _idx(state, body)
    return _dirty(_set(state, "bodies", i, on, enabled=flag), on)


def set_fixed_rotation(state: State, body, flag) -> State:
    """b2Body::SetFixedRotation: zeroes angular velocity, resets mass."""
    i, on = _idx(state, body)
    state = _set(state, "bodies", i, on, fixed_rotation=flag, w=0.0)
    return _reset_mass_data(state, body)


def set_linear_damping(state: State, body, value) -> State:
    i, on = _idx(state, body)
    return _set(state, "bodies", i, on, linear_damping=value)


def set_angular_damping(state: State, body, value) -> State:
    i, on = _idx(state, body)
    return _set(state, "bodies", i, on, angular_damping=value)


def set_gravity_scale(state: State, body, value) -> State:
    i, on = _idx(state, body)
    return _set(state, "bodies", i, on, gravity_scale=value)


def set_awake(state: State, body, flag: bool) -> State:
    """b2Body::SetAwake: waking resets the sleep timer; putting to sleep
    also zeroes the velocities and the force accumulators."""
    i, on = _idx(state, body)
    if flag:
        return _set(state, "bodies", i, on, awake=True, sleep_time=0.0)
    return _set(state, "bodies", i, on, awake=False, sleep_time=0.0, v=(0.0, 0.0),
                w=0.0, force=(0.0, 0.0), torque=0.0)


# --------------------------------------------------------------------------
# fixture and contact setters
# --------------------------------------------------------------------------


def set_friction(state: State, fixture, value) -> State:
    """b2Fixture::SetFriction (b2Fixture.h:187-194). The solver re-mixes
    contact friction from the fixtures every step, so this takes effect on
    existing contacts immediately."""
    i, on = _idx(state, fixture)
    return _set(state, "fixtures", i, on, friction=value)


def set_restitution(state: State, fixture, value) -> State:
    """b2Fixture::SetRestitution (b2Fixture.h:326-340); re-mixed per step
    like set_friction."""
    i, on = _idx(state, fixture)
    return _set(state, "fixtures", i, on, restitution=value)


def set_density(state: State, fixture, value) -> State:
    """b2Fixture::SetDensity + b2Body::ResetMassData (performed at once)."""
    i, on = _idx(state, fixture)
    state = _set(state, "fixtures", i, on, density=value)
    owner = torch.where(on, _row(state.fixtures.body, i).long(), -1)
    return _reset_mass_data(state, owner)


def _contact_slot(state: State, fixture_a, fixture_b):
    """The contact slot (W,) holding the canonical (fixture_a, fixture_b)
    pair in each world, and whether it was found (W,)."""
    ia, on_a = _idx(state, fixture_a)
    ib, on_b = _idx(state, fixture_b)
    c = state.contacts
    lo, hi = torch.minimum(ia, ib), torch.maximum(ia, ib)
    hit = ((torch.minimum(c.f_a, c.f_b) == lo[:, None])
           & (torch.maximum(c.f_a, c.f_b) == hi[:, None]) & (c.f_a >= 0)
           & (on_a & on_b)[:, None])
    return torch.argmax(hit.to(torch.int8), 1), hit.any(1)


def _set_contact(state: State, fixture_a, fixture_b, field, value) -> State:
    slot, found = _contact_slot(state, fixture_a, fixture_b)
    return _set(state, "contacts", slot, found, **{field: value})


def set_contact_tangent_speed(state: State, fixture_a, fixture_b, speed) -> State:
    """b2Contact::SetTangentSpeed (b2Contact.h:157): conveyor-belt surface
    speed in m/s along the contact tangent. Persists for the life of the
    pair; no-op in a world where the fixtures share no contact slot."""
    return _set_contact(state, fixture_a, fixture_b, "tangent_speed", speed)


def set_contact_friction(state: State, fixture_a, fixture_b, value=None) -> State:
    """b2Contact::SetFriction / ResetFriction (b2Contact.h:126-141):
    value=None restores the default fixture mixing."""
    return _set_contact(state, fixture_a, fixture_b, "friction_override",
                        -1.0 if value is None else value)


def set_contact_restitution(state: State, fixture_a, fixture_b, value=None) -> State:
    """b2Contact::SetRestitution / ResetRestitution (b2Contact.h:143-150)."""
    return _set_contact(state, fixture_a, fixture_b, "restitution_override",
                        -1.0 if value is None else value)


def set_sensor(state: State, fixture, flag) -> State:
    """b2Fixture::SetSensor."""
    i, on = _idx(state, fixture)
    return _set(state, "fixtures", i, on, is_sensor=flag)


def set_thick_shape(state: State, fixture, flag) -> State:
    """MT fork b2Fixture::SetThickShape (b2Fixture.cpp:241-258): opts the
    fixture out of non-bullet CCD (candidacy is evaluated per step)."""
    i, on = _idx(state, fixture)
    return _set(state, "fixtures", i, on, thick_shape=flag)


def set_filter(state: State, fixture, category=None, mask=None, group=None) -> State:
    """b2Fixture::SetFilterData + Refilter: the next step re-finds pairs."""
    i, on = _idx(state, fixture)
    kw = {k: v for k, v in (("filter_category", category), ("filter_mask", mask),
                            ("filter_group", group)) if v is not None}
    return _dirty(_set(state, "fixtures", i, on, **kw), on)


# --------------------------------------------------------------------------
# runtime world mutation: alloc/free into capacity slots
# (b2World::CreateBody/DestroyBody/CreateFixture, b2World.cpp:549-832)
# --------------------------------------------------------------------------


def _fixture_mass_all(fx):
    """Per-fixture (mass, center, inertia about the body origin) from the
    packed shape rows, the device form of b2Shape::ComputeMass
    (b2CircleShape.cpp:73-80, b2PolygonShape.cpp ComputeMass,
    b2EdgeShape.cpp:123-129; a chain's children are edges, massless).
    Returns ((W, F), (W, F, 2), (W, F))."""
    i8 = torch.arange(settings.MAX_POLYGON_VERTICES, device=fx.verts.device)
    n = fx.nverts.clamp_min(1)
    valid = i8 < fx.nverts[..., None]                              # (W, F, 8)

    # polygon: triangle fan about the vertex mean
    s = (torch.where(valid[..., None], fx.verts, 0.0).sum(2)
         / n[..., None].to(torch.float32))
    nxt = torch.where(i8 + 1 < fx.nverts[..., None], i8 + 1, 0)
    vnext = torch.gather(fx.verts, 2, nxt[..., None].expand(fx.verts.shape))
    e1 = fx.verts - s[:, :, None, :]
    e2 = vnext - s[:, :, None, :]
    d = torch.where(valid, e1[..., 0] * e2[..., 1] - e1[..., 1] * e2[..., 0], 0.0)
    tri = 0.5 * d
    area = tri.sum(2)
    safe_area = torch.where(area != 0.0, area, 1.0)
    center = ((tri / 3.0)[..., None] * (e1 + e2)).sum(2) / safe_area[..., None]
    intx2 = e1[..., 0] ** 2 + e2[..., 0] * e1[..., 0] + e2[..., 0] ** 2
    inty2 = e1[..., 1] ** 2 + e2[..., 1] * e1[..., 1] + e2[..., 1] ** 2
    i0 = torch.where(valid, 0.25 / 3.0 * d * (intx2 + inty2), 0.0).sum(2)
    mass_p = fx.density * area
    com_p = center + s
    inertia_p = fx.density * i0 + mass_p * ((com_p * com_p).sum(-1)
                                            - (center * center).sum(-1))

    # circle
    mass_c = fx.density * math.pi * fx.radius ** 2
    com_c = fx.verts[:, :, 0]
    inertia_c = mass_c * (0.5 * fx.radius ** 2 + (com_c * com_c).sum(-1))

    is_poly = fx.shape_type == settings.SHAPE_POLYGON
    is_circle = fx.shape_type == settings.SHAPE_CIRCLE
    exists = fx.body >= 0
    mass = torch.where(exists & is_poly, mass_p,
                       torch.where(exists & is_circle, mass_c, 0.0))
    com = torch.where(is_poly[..., None], com_p, com_c)
    inertia = torch.where(exists & is_poly, inertia_p,
                          torch.where(exists & is_circle, inertia_c, 0.0))
    return mass, com, inertia


def _reset_mass_data(state: State, body) -> State:
    """b2Body::ResetMassData (b2Body.cpp): recompute mass, center and
    inertia from the body's current fixtures; keeps the origin transform
    fixed and corrects the center velocity."""
    i, on = _idx(state, body)
    b, fx = state.bodies, state.fixtures
    fmass, fcom, finertia = _fixture_mass_all(fx)
    mine = fx.body == i[:, None]
    mass = torch.where(mine, fmass, 0.0).sum(1)
    lc = (torch.where(mine[..., None], fmass[..., None] * fcom, 0.0).sum(1)
          / torch.where(mass > 0.0, mass, 1.0)[:, None])
    inertia = torch.where(mine, finertia, 0.0).sum(1)

    dyn = _row(b.body_type, i) == settings.DYNAMIC_BODY
    has_mass = dyn & (mass > 0.0)
    mass = torch.where(dyn, torch.where(has_mass, mass, 1.0), 0.0)
    lc = torch.where(has_mass[:, None], lc, 0.0)
    inertia = torch.where(has_mass & ~_row(b.fixed_rotation, i),
                          inertia - mass * (lc * lc).sum(-1), 0.0)
    inv_mass = torch.where(dyn, 1.0 / torch.where(dyn, mass, 1.0), 0.0)
    inv_i = torch.where(inertia > 0.0, 1.0 / torch.where(inertia > 0.0, inertia, 1.0), 0.0)

    # move the sweep center, keep the origin; v += cross(w, c_new - c_old)
    q = rot_from_angle(_row(b.a, i))
    c_old = _row(b.c, i)
    c_new = c_old - rot_vec(q, _row(b.local_center, i)) + rot_vec(q, lc)
    dv = cross_sv(_row(b.w, i), c_new - c_old)
    state = _set(state, "bodies", i, on, inv_mass=inv_mass, inv_inertia=inv_i,
                 local_center=lc, c=c_new, c0=c_new)
    return _upd_bodies(state, v=_add(state.bodies.v, i, on, dv))


def _free_slot(taken, worlds):
    """(first free slot (W,) long, ok (W,) bool) of a (W, N) taken mask,
    in the worlds `worlds` (W,) bool."""
    free = ~taken
    idx = torch.argmax(free.to(torch.int8), 1)
    return idx, take(free, idx[:, None])[:, 0] & worlds


def add_body(state: State, body_type=settings.STATIC_BODY, position=(0.0, 0.0),
             angle=0.0, linear_velocity=(0.0, 0.0), angular_velocity=0.0,
             linear_damping=0.0, angular_damping=0.0, allow_sleep=True, awake=True,
             fixed_rotation=False, bullet=False, enabled=True, gravity_scale=1.0, *,
             worlds=None):
    """b2World::CreateBody (b2World.cpp:549-583) into the first free body
    slot of each world (of the worlds `worlds`, a (W,) bool tensor, when
    given). Returns (state, index (W,)); index is -1 where a world is full
    (its state unchanged). Dynamic bodies start with mass 1 until a fixture
    with density is added (b2Body ctor semantics)."""
    b = state.bodies
    worlds = (torch.ones(state.n_worlds, dtype=torch.bool, device=b.c.device)
              if worlds is None else _vals(state, worlds, (), torch.bool))
    idx, ok = _free_slot(b.body_type >= 0, worlds)
    body_type = _vals(state, body_type, (), torch.int32)
    position = _vals(state, position, (2,), torch.float32)
    angle = _vals(state, angle, (), torch.float32)
    state = _set(
        state, "bodies", idx, ok, body_type=body_type, c=position, a=angle,
        c0=position, a0=angle, alpha0=0.0, local_center=(0.0, 0.0),
        v=linear_velocity, w=angular_velocity, force=(0.0, 0.0), torque=0.0,
        inv_mass=(body_type == settings.DYNAMIC_BODY).to(torch.float32),
        inv_inertia=0.0, linear_damping=linear_damping,
        angular_damping=angular_damping, gravity_scale=gravity_scale, awake=awake,
        allow_sleep=allow_sleep, fixed_rotation=fixed_rotation, bullet=bullet,
        enabled=enabled, sleep_time=0.0)
    return state, torch.where(ok, idx, -1).to(torch.int32)


def _shape_row(shape) -> dict:
    """Host shape -> packed fixture row values (the single-fixture form of
    WorldBuilder's fixture packing)."""
    verts = np.zeros((settings.MAX_POLYGON_VERTICES, 2), np.float32)
    normals = np.zeros((settings.MAX_POLYGON_VERTICES, 2), np.float32)
    ghosts = np.zeros(2, bool)
    if isinstance(shape, shapes.Circle):
        stype, radius, nverts = settings.SHAPE_CIRCLE, shape.radius, 1
        verts[0] = shape.center
    elif isinstance(shape, shapes.Edge):
        stype, radius, nverts = settings.SHAPE_EDGE, shape.radius, 2
        verts[0] = shape.v1
        verts[1] = shape.v2
        if shape.v0 is not None:
            verts[2] = shape.v0
            ghosts[0] = True
        if shape.v3 is not None:
            verts[3] = shape.v3
            ghosts[1] = True
    elif isinstance(shape, shapes.Polygon):
        stype, radius = settings.SHAPE_POLYGON, shape.radius
        nverts = len(shape.vertices)
        verts[:nverts] = shape.vertices
        normals[:nverts] = shape.normals
    else:
        raise TypeError(f"unknown shape {type(shape)}")
    return dict(shape_type=np.int32(stype), radius=np.float32(radius),
                nverts=np.int32(nverts), verts=verts, normals=normals, ghosts=ghosts)


def add_fixture(state: State, body, shape, density=0.0, friction=0.2,
                restitution=0.0, is_sensor=False, filter_category=1,
                filter_mask=0xFFFF, filter_group=0, thick_shape=False):
    """b2Body::CreateFixture into the first free fixture slot of each
    world. `shape` is a host shapes.Circle/Edge/Polygon. Recomputes the
    body's mass data, fattens the new proxy's AABB and marks the pair
    table dirty. Returns (state, fixture index (W,)); -1 where full."""
    row = _shape_row(shape)
    bi, on = _idx(state, body)
    idx, ok = _free_slot(state.fixtures.body >= 0, on)
    state = _set(state, "fixtures", idx, ok, body=bi, friction=friction,
                 restitution=restitution, density=density, is_sensor=is_sensor,
                 filter_category=filter_category, filter_mask=filter_mask,
                 filter_group=filter_group, thick_shape=thick_shape,
                 **{k: torch.from_numpy(np.asarray(v)) for k, v in row.items()})
    state = _reset_mass_data(state, torch.where(on, bi, -1))

    # the initial fat AABB (b2DynamicTree::CreateProxy) + a dirty pair table
    b, fx = state.bodies, state.fixtures
    p, q = body_xf(b.c, b.a, b.local_center)
    fb = fx.body.clamp_min(0).long()
    lo, hi = broadphase.tight_aabbs(fx, take(p, fb), take(q, fb))
    sel = _rows(fx.body, idx, ok)[..., None]
    state = dataclasses.replace(state, fixtures=dataclasses.replace(
        fx, aabb_lo=torch.where(sel, lo - settings.AABB_EXTENSION, fx.aabb_lo),
        aabb_hi=torch.where(sel, hi + settings.AABB_EXTENSION, fx.aabb_hi)))
    return _dirty(state, on), torch.where(ok, idx, -1).to(torch.int32)


def _clear_contacts_of_fixtures(state: State, fmask, on) -> State:
    """Kill the contact slots referencing the masked fixtures (W, F)
    (DestroyBody clears the body's contact list at once,
    b2World.cpp:636-649), in the worlds `on`."""
    c = state.contacts
    dead = (take(fmask, c.f_a.clamp_min(0).long())
            | take(fmask, c.f_b.clamp_min(0).long()))
    contacts = dataclasses.replace(
        c, f_a=torch.where(dead, -1, c.f_a), f_b=torch.where(dead, -1, c.f_b),
        touching=c.touching & ~dead, m_count=torch.where(dead, 0, c.m_count))
    return _dirty(dataclasses.replace(state, contacts=contacts), on)


def remove_fixture(state: State, fixture) -> State:
    """b2Body::DestroyFixture: free the slot, recompute the body's mass,
    drop its contacts, dirty the pair table."""
    i, on = _idx(state, fixture)
    fx = state.fixtures
    owner = torch.where(on, _row(fx.body, i).long(), -1)
    sel = _rows(fx.body, i, on)
    state = dataclasses.replace(state, fixtures=dataclasses.replace(
        fx, body=torch.where(sel, -1, fx.body)))
    state = _clear_contacts_of_fixtures(state, sel, on)
    return _reset_mass_data(state, owner)


def remove_body(state: State, body) -> State:
    """b2World::DestroyBody (b2World.cpp:585-677): free the body slot, its
    fixtures, its contacts; deactivate the joints attached to it."""
    i, on = _idx(state, body)
    fx = state.fixtures
    fmask = (fx.body == i[:, None]) & on[:, None]
    state = dataclasses.replace(state, fixtures=dataclasses.replace(
        fx, body=torch.where(fmask, -1, fx.body)))
    state = _set(state, "bodies", i, on, body_type=-1, v=(0.0, 0.0), w=0.0, awake=False)
    state = _clear_contacts_of_fixtures(state, fmask, on)

    # deactivate the attached joints (DestroyBody destroys the joint list)
    upd = {}
    for name, _ in JOINT_BLOCKS:
        blk = getattr(state.joints, name)
        if blk.body_a.shape[-1] == 0:
            continue
        hit = (blk.body_a == i[:, None]) | (blk.body_b == i[:, None])
        if name == "gear":
            hit = hit | (blk.body_c == i[:, None]) | (blk.body_d == i[:, None])
        upd[name] = dataclasses.replace(blk, active=blk.active & ~(hit & on[:, None]))
    if upd:
        state = dataclasses.replace(state, joints=dataclasses.replace(state.joints, **upd))
    return state


# --------------------------------------------------------------------------
# runtime joint creation: b2World::CreateJoint (b2World.cpp:679-832) into
# the preallocated slots of each type (WorldBuilder.freeze(joint_capacity=
# {...})). Anchors resolve against the bodies' CURRENT transforms, on the
# device, as the reference joint Initialize() helpers do.
# --------------------------------------------------------------------------


def _body_origin_q(b, i):
    q = rot_from_angle(_row(b.a, i))
    return _row(b.c, i) - rot_vec(q, _row(b.local_center, i)), q


def _local_point(b, i, world_point):
    """b2Body::GetLocalPoint at the current transform, (W, 2)."""
    origin, q = _body_origin_q(b, i)
    d = world_point - origin
    s, c = q[..., 0], q[..., 1]
    return torch.stack([c * d[..., 0] + s * d[..., 1], -s * d[..., 0] + c * d[..., 1]], -1)


def _local_vector(b, i, world_vec):
    """b2Body::GetLocalVector at the current transform, (W, 2)."""
    q = rot_from_angle(_row(b.a, i))
    s, c = q[..., 0], q[..., 1]
    v = world_vec
    return torch.stack([c * v[..., 0] + s * v[..., 1], -s * v[..., 0] + c * v[..., 1]], -1)


def _joint_add(state: State, kind: str, fields: dict, on):
    """Write a new joint into the first inactive slot of its typed block in
    each world `on`. Returns (state, index (W,)); -1 where the block is
    full. Sets pairs_dirty so that collide_connected filtering applies at
    the next step (the reference updates contact filter flags on
    CreateJoint, b2World.cpp:796-812)."""
    blk = getattr(state.joints, kind)
    if blk.body_a.shape[-1] == 0:
        raise ValueError(
            f"no '{kind}' joint slots: build the world with "
            f"freeze(joint_capacity={{'{kind}': n}}) to enable runtime creation")
    idx, ok = _free_slot(blk.active, on)
    upd = {}
    for name, val in fields.items():
        arr = getattr(blk, name)
        upd[name] = _put(arr, idx, ok, _vals(state, val, arr.shape[2:], arr.dtype))
    # fresh slots start with zero accumulated impulses and an inactive limit
    for name in blk.__dataclass_fields__:
        if name.endswith("impulse") or name == "limit_state":
            arr = getattr(blk, name)
            upd[name] = _put(arr, idx, ok, torch.zeros_like(arr[:, 0]))
    upd["active"] = blk.active | _rows(blk.active, idx, ok)
    state = dataclasses.replace(state, joints=dataclasses.replace(
        state.joints, **{kind: dataclasses.replace(blk, **upd)}))
    return _dirty(state, on), torch.where(ok, idx, -1).to(torch.int32)


def _pair(state, body_a, body_b):
    ia, on_a = _idx(state, body_a)
    ib, on_b = _idx(state, body_b)
    return ia, ib, on_a & on_b


def _vec(state, v):
    return _vals(state, v, (2,), torch.float32)


def add_revolute_joint(state: State, body_a, body_b, anchor, *,
                       collide_connected=False, enable_limit=False,
                       lower_angle=0.0, upper_angle=0.0, enable_motor=False,
                       motor_speed=0.0, max_motor_torque=0.0, reference_angle=None):
    """b2RevoluteJointDef::Initialize at the current body transforms."""
    ia, ib, on = _pair(state, body_a, body_b)
    b = state.bodies
    anchor = _vec(state, anchor)
    if reference_angle is None:
        reference_angle = _row(b.a, ib) - _row(b.a, ia)
    return _joint_add(state, "revolute", dict(
        body_a=ia, body_b=ib, local_anchor_a=_local_point(b, ia, anchor),
        local_anchor_b=_local_point(b, ib, anchor), reference_angle=reference_angle,
        collide_connected=collide_connected, enable_limit=enable_limit,
        lower_angle=lower_angle, upper_angle=upper_angle, enable_motor=enable_motor,
        motor_speed=motor_speed, max_motor_torque=max_motor_torque), on)


def add_distance_joint(state: State, body_a, body_b, anchor_a, anchor_b, *,
                       collide_connected=False, frequency=0.0, damping_ratio=0.0,
                       length=None):
    """b2DistanceJointDef::Initialize at the current body transforms."""
    ia, ib, on = _pair(state, body_a, body_b)
    b = state.bodies
    anchor_a, anchor_b = _vec(state, anchor_a), _vec(state, anchor_b)
    if length is None:
        d = anchor_b - anchor_a
        length = torch.sqrt((d * d).sum(-1))
    length = torch.clamp_min(_vals(state, length, (), torch.float32), settings.LINEAR_SLOP)
    return _joint_add(state, "distance", dict(
        body_a=ia, body_b=ib, local_anchor_a=_local_point(b, ia, anchor_a),
        local_anchor_b=_local_point(b, ib, anchor_b), length=length,
        frequency=frequency, damping_ratio=damping_ratio,
        collide_connected=collide_connected), on)


def add_prismatic_joint(state: State, body_a, body_b, anchor, axis, *,
                        collide_connected=False, enable_limit=False,
                        lower_translation=0.0, upper_translation=0.0,
                        enable_motor=False, motor_speed=0.0, max_motor_force=0.0,
                        reference_angle=None):
    ia, ib, on = _pair(state, body_a, body_b)
    b = state.bodies
    anchor = _vec(state, anchor)
    if reference_angle is None:
        reference_angle = _row(b.a, ib) - _row(b.a, ia)
    return _joint_add(state, "prismatic", dict(
        body_a=ia, body_b=ib, local_anchor_a=_local_point(b, ia, anchor),
        local_anchor_b=_local_point(b, ib, anchor),
        local_axis_a=_local_vector(b, ia, _vec(state, axis)),
        reference_angle=reference_angle, collide_connected=collide_connected,
        enable_limit=enable_limit, lower_translation=lower_translation,
        upper_translation=upper_translation, enable_motor=enable_motor,
        motor_speed=motor_speed, max_motor_force=max_motor_force), on)


def add_weld_joint(state: State, body_a, body_b, anchor, *, collide_connected=False,
                   frequency=0.0, damping_ratio=0.0, reference_angle=None):
    ia, ib, on = _pair(state, body_a, body_b)
    b = state.bodies
    anchor = _vec(state, anchor)
    if reference_angle is None:
        reference_angle = _row(b.a, ib) - _row(b.a, ia)
    return _joint_add(state, "weld", dict(
        body_a=ia, body_b=ib, local_anchor_a=_local_point(b, ia, anchor),
        local_anchor_b=_local_point(b, ib, anchor), reference_angle=reference_angle,
        frequency=frequency, damping_ratio=damping_ratio,
        collide_connected=collide_connected), on)


def add_friction_joint(state: State, body_a, body_b, anchor, *, collide_connected=False,
                       max_force=0.0, max_torque=0.0):
    ia, ib, on = _pair(state, body_a, body_b)
    b = state.bodies
    anchor = _vec(state, anchor)
    return _joint_add(state, "friction", dict(
        body_a=ia, body_b=ib, local_anchor_a=_local_point(b, ia, anchor),
        local_anchor_b=_local_point(b, ib, anchor), max_force=max_force,
        max_torque=max_torque, collide_connected=collide_connected), on)


def add_rope_joint(state: State, body_a, body_b, local_anchor_a, local_anchor_b,
                   max_length, *, collide_connected=False):
    ia, ib, on = _pair(state, body_a, body_b)
    return _joint_add(state, "rope", dict(
        body_a=ia, body_b=ib, local_anchor_a=local_anchor_a,
        local_anchor_b=local_anchor_b, max_length=max_length,
        collide_connected=collide_connected), on)


def add_motor_joint(state: State, body_a, body_b, *, collide_connected=False,
                    max_force=1.0, max_torque=1.0, correction_factor=0.3,
                    linear_offset=None, angular_offset=None):
    """b2MotorJointDef::Initialize: the defaults are the current relative
    transform."""
    ia, ib, on = _pair(state, body_a, body_b)
    b = state.bodies
    if linear_offset is None:
        linear_offset = _local_point(b, ia, _body_origin_q(b, ib)[0])
    if angular_offset is None:
        angular_offset = _row(b.a, ib) - _row(b.a, ia)
    return _joint_add(state, "motor", dict(
        body_a=ia, body_b=ib, linear_offset=linear_offset,
        angular_offset=angular_offset, max_force=max_force, max_torque=max_torque,
        correction_factor=correction_factor, collide_connected=collide_connected), on)


def add_mouse_joint(state: State, body_b, target, *, max_force=0.0, frequency=5.0,
                    damping_ratio=0.7):
    """b2MouseJoint creation mid-run (the interactive-drag idiom). Wakes the
    dragged body (the testbed does SetAwake on pick)."""
    ib, on = _idx(state, body_b)
    state = set_awake(state, body_b, True)
    target = _vec(state, target)
    return _joint_add(state, "mouse", dict(
        body_a=ib, body_b=ib, target=target,
        local_anchor_b=_local_point(state.bodies, ib, target), max_force=max_force,
        frequency=frequency, damping_ratio=damping_ratio, collide_connected=True), on)


def add_wheel_joint(state: State, body_a, body_b, anchor, axis, *,
                    collide_connected=False, enable_motor=False, motor_speed=0.0,
                    max_motor_torque=0.0, frequency=2.0, damping_ratio=0.7):
    ia, ib, on = _pair(state, body_a, body_b)
    b = state.bodies
    anchor = _vec(state, anchor)
    return _joint_add(state, "wheel", dict(
        body_a=ia, body_b=ib, local_anchor_a=_local_point(b, ia, anchor),
        local_anchor_b=_local_point(b, ib, anchor),
        local_axis_a=_local_vector(b, ia, _vec(state, axis)),
        enable_motor=enable_motor, motor_speed=motor_speed,
        max_motor_torque=max_motor_torque, frequency=frequency,
        damping_ratio=damping_ratio, collide_connected=collide_connected), on)


def add_pulley_joint(state: State, body_a, body_b, ground_anchor_a, ground_anchor_b,
                     anchor_a, anchor_b, ratio=1.0, *, collide_connected=True):
    ia, ib, on = _pair(state, body_a, body_b)
    b = state.bodies
    ga, gb = _vec(state, ground_anchor_a), _vec(state, ground_anchor_b)
    aa, ab = _vec(state, anchor_a), _vec(state, anchor_b)
    return _joint_add(state, "pulley", dict(
        body_a=ia, body_b=ib, ground_anchor_a=ga, ground_anchor_b=gb,
        local_anchor_a=_local_point(b, ia, aa), local_anchor_b=_local_point(b, ib, ab),
        length_a=torch.sqrt(((aa - ga) ** 2).sum(-1)),
        length_b=torch.sqrt(((ab - gb) ** 2).sum(-1)), ratio=ratio,
        collide_connected=collide_connected), on)


def _gear_coordinate_device(state: State, jtype: int, jindex):
    """The current gear coordinate (W,) and geometry of one coupled joint
    in each world (b2GearJoint.cpp:70-123, at the current transforms)."""
    b = state.bodies
    block = state.joints.revolute if jtype == 0 else state.joints.prismatic
    nw, dev = state.n_worlds, b.c.device
    j, _ = _idx(state, jindex)
    if block.body_a.shape[-1]:
        j = j.clamp_max(block.body_a.shape[-1] - 1)
        body_aj, body_bj = _row(block.body_a, j).long(), _row(block.body_b, j).long()
        anc_a, anc_b = _row(block.local_anchor_a, j), _row(block.local_anchor_b, j)
        ref = _row(block.reference_angle, j)
    else:
        body_aj = body_bj = torch.zeros(nw, dtype=torch.long, device=dev)
        anc_a = anc_b = torch.zeros((nw, 2), device=dev)
        ref = torch.zeros(nw, device=dev)
    if jtype == 0:
        axis = torch.zeros((nw, 2), device=dev)
        # revolute coordinate: aB - aA - ref
        coord = _row(b.a, body_bj) - _row(b.a, body_aj) - ref
    else:
        axis = (_row(block.local_axis_a, j) if block.body_a.shape[-1]
                else torch.zeros((nw, 2), device=dev))
        # prismatic: dot(pB in A's frame - anchorA, axisA)
        origin_a, qa = _body_origin_q(b, body_aj)
        origin_b, qb = _body_origin_q(b, body_bj)
        w = rot_vec(qb, anc_b) + origin_b - origin_a
        s, c = qa[..., 0], qa[..., 1]
        p_in_a = torch.stack([c * w[..., 0] + s * w[..., 1],
                              -s * w[..., 0] + c * w[..., 1]], -1)
        coord = ((p_in_a - anc_a) * axis).sum(-1)
    return coord, dict(body_a=body_aj, body_b=body_bj, anchor_a=anc_a,
                       anchor_b=anc_b, ref=ref, axis=axis)


def add_gear_joint(state: State, joint1, joint2, ratio=1.0, *, collide_connected=False):
    """b2GearJoint creation mid-run. joint1/joint2 are ("revolute" |
    "prismatic", index) references to existing joints (as with
    WorldBuilder.create_gear_joint); an index may be batched."""
    (kind1, i1), (kind2, i2) = joint1, joint2
    t1 = 0 if kind1 == "revolute" else 1
    t2 = 0 if kind2 == "revolute" else 1
    _, on1 = _idx(state, i1)
    _, on2 = _idx(state, i2)
    coord1, g1 = _gear_coordinate_device(state, t1, i1)
    coord2, g2 = _gear_coordinate_device(state, t2, i2)
    ratio = _vals(state, ratio, (), torch.float32)
    return _joint_add(state, "gear", dict(
        body_a=g1["body_b"], body_b=g2["body_b"], body_c=g1["body_a"],
        body_d=g2["body_a"], joint1_type=t1, joint1_index=_idx(state, i1)[0],
        joint2_type=t2, joint2_index=_idx(state, i2)[0],
        local_anchor_a=g1["anchor_b"], local_anchor_c=g1["anchor_a"],
        local_anchor_b=g2["anchor_b"], local_anchor_d=g2["anchor_a"],
        local_axis_c=g1["axis"], local_axis_d=g2["axis"],
        reference_angle_a=g1["ref"], reference_angle_b=g2["ref"], ratio=ratio,
        constant=coord1 + ratio * coord2, collide_connected=collide_connected),
        on1 & on2)


def set_mouse_target(state: State, index, target) -> State:
    """b2MouseJoint::SetTarget (b2MouseJoint.h:77): move the drag target
    between steps; wakes the dragged body."""
    i, on = _idx(state, index)
    mj = state.joints.mouse
    state = dataclasses.replace(state, joints=dataclasses.replace(
        state.joints, mouse=dataclasses.replace(
            mj, target=_put(mj.target, i, on, _vec(state, target)))))
    return set_awake(state, torch.where(on, _row(mj.body_b, i).long(), -1), True)


def remove_joint(state: State, kind: str, index) -> State:
    """b2World::DestroyJoint analog: deactivate the joint slot."""
    i, on = _idx(state, index)
    blk = getattr(state.joints, kind)
    blk = dataclasses.replace(blk, active=blk.active & ~_rows(blk.active, i, on))
    return _dirty(dataclasses.replace(
        state, joints=dataclasses.replace(state.joints, **{kind: blk})), on)


def shift_origin(state: State, new_origin) -> State:
    """b2World::ShiftOrigin (b2World.cpp:2084-2105): subtract `new_origin`
    ((2,) or (W, 2)) from every world-frame position: body transforms and
    sweep centers, mouse-joint targets (b2MouseJoint.cpp:220-223), pulley
    ground anchors (b2PulleyJoint.cpp:345-349) and the broad-phase fat
    AABBs (so no pair refresh is triggered; overlap is
    translation-invariant)."""
    o = _vec(state, new_origin)[:, None]
    b, fx = state.bodies, state.fixtures
    state = dataclasses.replace(
        state, bodies=dataclasses.replace(b, c=b.c - o, c0=b.c0 - o),
        fixtures=dataclasses.replace(fx, aabb_lo=fx.aabb_lo - o, aabb_hi=fx.aabb_hi - o))
    joints, upd = state.joints, {}
    if joints.mouse.body_a.shape[-1]:
        upd["mouse"] = dataclasses.replace(joints.mouse, target=joints.mouse.target - o)
    if joints.pulley.body_a.shape[-1]:
        pj = joints.pulley
        upd["pulley"] = dataclasses.replace(pj, ground_anchor_a=pj.ground_anchor_a - o,
                                            ground_anchor_b=pj.ground_anchor_b - o)
    if upd:
        state = dataclasses.replace(state, joints=dataclasses.replace(joints, **upd))
    return state
