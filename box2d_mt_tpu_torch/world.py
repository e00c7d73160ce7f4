"""World construction and the batched step.

Port of `box2d_mt_tpu.world`: `WorldBuilder` (b2World::CreateBody,
b2Body::CreateFixture) packs host shapes into a batched `State` of
tensors, and `step_batched` is b2World::Step (b2World.cpp:1613-1710) over
a batch of worlds, in the JAX package's phase order:

  1. Collide: manifolds for the persistent pair table, warm-start id
     matching, touch transitions wake bodies (`_collide_b`, `_pre_touch`).
  2. Solve: island labels + awake propagation and the constraint coloring,
     both cached across steps on graph signatures; velocity integration,
     constraint init, warm start (`_pre_finish`); the solve middle (one
     CUDA kernel on a card), or for worlds with joints the sandwich: the
     joint passes between one contact-iteration kernel per launch
     (`_solve_sandwich_b`); sleep (`_post_sleep_sync`).
  3. Synchronize fat AABBs, refresh the pair table and carry warm-start
     state over (`_post_solve_b`).
  4. Continuous collision (`continuous=True`): behind a body-motion
     pre-gate, rounds of per-lane time of impact (CUDA kernel on a card)
     and disjoint TOI sub-steps with mini islands (`_solve_toi_b`).

Each `lax.cond` / `lax.while_loop` predicate of the JAX program is read
back to the host here; `Events.host_syncs` counts those reads per step.
A predicate is read over the whole batch, but every branch leaves the
worlds it does not concern as stepping them alone would: a world whose
bodies all sleep, whose fixtures stay inside their fat AABBs or that
moves too little for a time of impact comes out as it would alone, so no
world's result depends on its batch (`parallel/sharding.py` steps shards
of a batch with no exchange between them).

The pair table comes from the all-pairs finder up to 1024 fixture slots
and from the grid hash above; K1 and the sweep kernels keep a world's
body planes in global memory where they do not fit a block's shared
memory, so no world size the JAX package steps is refused.

The PreSolve hook (`pre_solve_fn`) and the contact-filter hook
(`filter_fn`) see the whole batch at once: they are called on the
batched state and views with a leading world axis, not vmapped per world
as in the JAX package (see `PreSolveView`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import settings, shapes, trace
from .math2d import add_rows, body_xf, rot_from_angle, rot_vec, take
from .ops import broadphase, coloring, distance, integrate, islands
from .ops import narrowphase as nph
from .ops import solver as csolver
from .joints import (_BLOCK_NAMES, build_joint_arrays, build_joints, init_joints,
                     solve_joint_position, solve_joint_velocity,
                     store_joint_impulses, warm_start_joints)
from .ops.solve_middle import SANDWICH, Sandwich, solve_middle
from .ops.toi import time_of_impact_lanes, toi_substep_passes
from .ops.sync import HostSyncs
from .state import (Bodies, Contacts, Fixtures, Joints, SolverCache, State,
                    make_empty_cache, where_worlds)


class Events(NamedTuple):
    """Per-step outputs replacing b2ContactListener callbacks; the fields
    of the JAX package's Events, the TOI sub-steps' impulses (which the
    JAX package does not report) and the step's host-sync count."""
    begin_touch: torch.Tensor    # (W,C) bool
    end_touch: torch.Tensor      # (W,C) bool
    f_a: torch.Tensor            # (W,C) i32 pair fixtures the masks refer to
    f_b: torch.Tensor
    pair_overflow: torch.Tensor  # (W,) i32
    color_overflow: torch.Tensor  # (W,) i32
    toi_overflow: torch.Tensor   # (W,) i32
    normal_impulse: torch.Tensor   # (W,C,2) PostSolve impulses
    tangent_impulse: torch.Tensor  # (W,C,2)
    touching: torch.Tensor       # (W,C) bool
    toi_begin: torch.Tensor      # (W,C) bool TOI-created touches (toi_f_a/b basis)
    toi_f_a: torch.Tensor        # (W,C) i32 refreshed pair fixtures
    toi_f_b: torch.Tensor
    # PostSolve of the TOI islands (b2Island::SolveTOI -> Report): each
    # pair's impulses in its last TOI sub-step this step (its mini-island
    # neighbors' too), 0 elsewhere, on the toi_f_a/b basis
    toi_normal_impulse: torch.Tensor   # (W,C,2)
    toi_tangent_impulse: torch.Tensor  # (W,C,2)
    host_syncs: int              # device-to-host predicate reads this step


class PreSolveView(NamedTuple):
    """What a `pre_solve_fn` sees: the analog of
    b2ContactListener::PreSolve(contact, oldManifold)
    (b2WorldCallbacks.h:110-118) for every contact slot of every world,
    the fresh manifold beside the previous step's. The fields are the JAX
    package's, each with a leading world axis: (W, C) where the JAX view
    has (C,).

    The hook is `pre_solve_fn(states, view)`, called once on the whole
    batch (the JAX package vmaps a per-world hook instead); it reads the
    batch as a user would, e.g. `states.bodies.c[:, 2, 1]` for body 2's
    height in every world. It returns a (W, C) bool tensor (False
    disables that contact for this step's solve: SetEnabled(false), the
    one-sided-platform idiom, Testbed/Tests/OneSidedPlatform.h) or a dict
    with any of
      "enabled":       (W, C) bool  as above
      "tangent_speed": (W, C) float b2Contact::SetTangentSpeed
                                    (the ConveyorBelt.h idiom)
      "friction":      (W, C) float b2Contact::SetFriction (-1 = mix)
      "restitution":   (W, C) float b2Contact::SetRestitution (-1 = mix)
    The dict's values are written to the persistent per-contact fields,
    as the reference's setters persist on the contact. Any other shape,
    dtype or key raises.

    The hook is consulted where the reference runs PreSolve (in
    b2Contact::Update): between collide and solve on the step's pair
    table, with the bodies where the step starts; and at every TOI
    sub-step, with the bodies at their TOI poses (b2World.cpp:860-874),
    where a disabled lane consumes its event without a sub-step. TOI
    candidacy reads the enabled flag the collide pass left on each
    contact (b2World.cpp:1534-1541); a pair created by the step's pair
    refresh starts enabled. The JAX package instead asks its hook again
    on the refreshed table and at the sub-steps with the bodies where the
    step ends, so a one-sided platform's hook that reads the actor's
    height disables the catch from above (its one_sided_platform_240
    golden then fails, at 10.5 m against a 0.05 bound); the two agree on
    hooks whose answer does not depend on the bodies' positions."""
    f_a: torch.Tensor            # (W,C) i32
    f_b: torch.Tensor
    body_a: torch.Tensor         # (W,C) i32
    body_b: torch.Tensor
    touching: torch.Tensor       # (W,C) bool (this step)
    manifold: object             # ops.narrowphase.Manifold, (W,C,...) leaves
    old_mtype: torch.Tensor      # the previous manifold (warm-start source)
    old_local_normal: torch.Tensor
    old_count: torch.Tensor
    tangent_speed: torch.Tensor        # (W,C) current per-contact values
    friction_override: torch.Tensor    # (W,C) -1 = unset
    restitution_override: torch.Tensor  # (W,C) -1 = unset


# a pre_solve_fn's dict keys beside "enabled", and the contact fields they set
_HOOK_FIELDS = {"tangent_speed": "tangent_speed", "friction": "friction_override",
                "restitution": "restitution_override"}


def _hook_out(out, like: torch.Tensor):
    """A pre_solve_fn's return value checked against the (W, C) slot
    shape: (enabled (W, C) bool or None, {contact field: (W, C) f32})."""
    def check(name, x, is_bool):
        if (not torch.is_tensor(x) or x.shape != like.shape or x.device != like.device
                or (x.dtype == torch.bool) != is_bool
                or not (is_bool or x.is_floating_point())):
            kind = "bool" if is_bool else "floating"
            raise ValueError(f"pre_solve_fn: {name} must be a {kind} tensor of shape "
                             f"{tuple(like.shape)} on {like.device}, got "
                             f"{getattr(x, 'dtype', type(x))} "
                             f"{tuple(getattr(x, 'shape', ()))}")
        return x if is_bool else x.to(torch.float32)

    if not isinstance(out, dict):
        return check("the mask", out, True), {}
    unknown = set(out) - set(_HOOK_FIELDS) - {"enabled"}
    if unknown:
        raise ValueError(f"pre_solve_fn: unknown keys {sorted(unknown)}")
    enabled = check("enabled", out["enabled"], True) if "enabled" in out else None
    return enabled, {_HOOK_FIELDS[k]: check(k, v, False)
                     for k, v in out.items() if k != "enabled"}


def _table_view(states: State, manifold, body_a, body_b, touching) -> PreSolveView:
    c = states.contacts
    return PreSolveView(
        f_a=c.f_a, f_b=c.f_b, body_a=body_a.to(torch.int32),
        body_b=body_b.to(torch.int32), touching=touching, manifold=manifold,
        old_mtype=c.m_type, old_local_normal=c.m_local_normal, old_count=c.m_count,
        tangent_speed=c.tangent_speed, friction_override=c.friction_override,
        restitution_override=c.restitution_override)


class _PreTouch(NamedTuple):
    contacts: Contacts
    awake0: torch.Tensor      # (W,N) pre-island-propagation awake
    non_static: torch.Tensor  # (W,N)
    solvable: torch.Tensor    # (W,C)
    dyn_a: torch.Tensor       # (W,C) conflicting endpoints
    dyn_b: torch.Tensor
    begin_touch: torch.Tensor
    end_touch: torch.Tensor


class _PreSolve(NamedTuple):
    """Everything the solve middle and the post phase need."""
    contacts: Contacts
    awake: torch.Tensor
    labels: torch.Tensor
    non_static: torch.Tensor
    solve_mask: torch.Tensor
    c0: torch.Tensor
    a0: torch.Tensor
    cc: csolver.ContactConstraints
    color: torch.Tensor
    color_overflow: torch.Tensor
    ni_it: torch.Tensor
    ti_it: torch.Tensor
    bs: torch.Tensor           # (W,3,N) warm-started [vx; vy; w]
    ba: torch.Tensor
    bb: torch.Tensor
    dyn_a: torch.Tensor
    dyn_b: torch.Tensor
    cc_active: torch.Tensor
    dt_ratio: torch.Tensor     # (W,) this dt over the previous step's
    begin_touch: torch.Tensor
    end_touch: torch.Tensor


class _Table(NamedTuple):
    """What the step read of its pair table before the collide phase."""
    kinds: tuple              # the contact kinds that have a pair
    kind: torch.Tensor        # (W,C) i32 contact kind of each pair
    sensor: torch.Tensor      # (W,C) bool existing sensor pairs
    any_sensor: bool


class _Mids(NamedTuple):
    ni_it: torch.Tensor
    ti_it: torch.Tensor
    c: torch.Tensor
    a: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor
    min_sep: torch.Tensor
    # worlds with joints: per-body "every joint here converged" and the
    # joints with this step's impulses and limit states
    jok: Optional[torch.Tensor] = None
    joints: Optional[Joints] = None


# --------------------------------------------------------------------------
# step phases
# --------------------------------------------------------------------------


def _pair_kinds(states: State):
    """The pair table's contact kind (W, C) i32 and its sensor pairs
    (W, C) bool, existing pairs only."""
    fx, table = states.fixtures, states.contacts
    ia, ib = table.f_a.clamp_min(0).long(), table.f_b.clamp_min(0).long()
    kind = nph.contact_kind(take(fx.shape_type, ia), take(fx.shape_type, ib))
    sensor = (take(fx.is_sensor, ia) | take(fx.is_sensor, ib)) & (table.f_a >= 0)
    return kind, sensor


def _table_flags(kind, sensor, exists, kinds):
    """Device predicates: some sensor pair exists; for each of `kinds`,
    some pair of that kind exists."""
    return (sensor.any(), *(((kind == k) & exists).any() for k in kinds))


def _collide_b(states: State, table: _Table, syncs: HostSyncs):
    """Batched narrow phase (b2ContactManager::Collide). Every kind of
    `table.kinds` runs over all contact lanes and each lane keeps its own
    kind's result. Sensor pairs also get their touch from
    `distance.test_overlap` (b2Contact::Update's sensor branch,
    b2Contact.cpp:193-202), run on the sensor lanes only and only when a
    sensor pair exists. Returns (manifold (W,C,...), sensor_touch, ba, bb)."""
    kind, sensor = table.kind, table.sensor
    fx, contacts, bodies = states.fixtures, states.contacts, states.bodies
    nw, nc = contacts.f_a.shape
    ia = contacts.f_a.clamp_min(0).long()
    ib = contacts.f_b.clamp_min(0).long()
    pair_exists = contacts.f_a >= 0
    ba = take(fx.body, ia).clamp_min(0).long()
    bb = take(fx.body, ib).clamp_min(0).long()

    p_all, q_all = body_xf(bodies.c, bodies.a, bodies.local_center)
    flat = lambda x: x.reshape((nw * nc,) + x.shape[2:])

    def lanes(idx, b):
        shape = nph.lanes_from_rows(
            flat(take(fx.verts, idx)), flat(take(fx.normals, idx)),
            flat(take(fx.nverts, idx)), flat(take(fx.ghosts, idx)),
            flat(take(fx.radius, idx)))
        p, q = flat(take(p_all, b)), flat(take(q_all, b))
        return shape, p[:, 0], p[:, 1], q[:, 0], q[:, 1]

    sensor_touch = torch.zeros_like(pair_exists)
    n_s = syncs.value(sensor.sum()) if table.any_sensor else 0
    if n_s:
        smask = sensor.reshape(-1)
        lane = torch.argsort(smask.to(torch.int8), descending=True, stable=True)[:n_s]
        world = lane // nc

        def proxy(f, b):
            f, b = f.reshape(-1)[lane], b.reshape(-1)[lane]
            return (fx.verts[world, f], fx.nverts[world, f], fx.radius[world, f],
                    p_all[world, b], q_all[world, b])

        touch = distance.test_overlap(*proxy(ia, ba), *proxy(ib, bb), syncs=syncs)
        sensor_touch = sensor_touch.reshape(-1).index_put(
            (lane,), touch).reshape(nw, nc)

    la, lb = lanes(ia, ba), lanes(ib, bb)
    dev = ia.device
    zi = torch.zeros((nw, nc), dtype=torch.int32, device=dev)
    man = nph.Manifold(
        mtype=zi, local_point=torch.zeros((nw, nc, 2), device=dev),
        local_normal=torch.zeros((nw, nc, 2), device=dev),
        points=torch.zeros((nw, nc, 2, 2), device=dev),
        ids=torch.zeros((nw, nc, 2), dtype=torch.int32, device=dev), count=zi)
    for k in table.kinds:
        mk = nph.lanes_to_manifold(nph.CORE_COLLIDERS[k](*la, *lb))
        sel = (kind == k) & pair_exists
        man = nph.Manifold(*(
            torch.where(sel.reshape(sel.shape + (1,) * (old.dim() - 2)),
                        new.reshape(old.shape), old)
            for new, old in zip(mk, man)))
    return man, sensor_touch, ba, bb


def _pre_touch(state: State, manifold: nph.Manifold, sensor, sensor_touch,
               ba, bb, enabled=None) -> _PreTouch:
    """Touch transitions + warm-start id matching + wake hits (the
    b2Contact::Update tail). A sensor pair touches when its shapes
    overlap, keeps no manifold points, wakes nobody when its touch changes
    and is never solved (b2Contact.cpp:193-205); a pair the PreSolve hook
    disables (`enabled` False; None: every pair enabled) touches but is
    not solved."""
    bodies, contacts = state.bodies, state.contacts
    nw, nb = bodies.body_type.shape
    pair_exists = contacts.f_a >= 0
    touching = pair_exists & torch.where(sensor, sensor_touch, manifold.count > 0)

    # warm-start impulse matching by feature id (b2Contact.cpp:210-230)
    two = torch.arange(2, device=ba.device)
    new_valid = two < manifold.count[..., None]
    old_valid = two < contacts.m_count[..., None]
    same = ((manifold.ids[..., :, None] == contacts.m_ids[..., None, :])
            & new_valid[..., :, None] & old_valid[..., None, :])
    match0 = same[..., 0]
    match1 = same[..., 1] & ~match0

    def matched(old):
        return torch.where(match0, old[..., 0:1],
                           torch.where(match1, old[..., 1:2], 0.0))

    # touch transitions wake both bodies (non-sensor)
    changed = pair_exists & ~sensor & (touching != contacts.touching)
    hit = torch.zeros((nw, nb + 1), dtype=torch.bool, device=ba.device)
    dump = torch.full_like(ba, nb)
    hit.scatter_(1, torch.cat([torch.where(changed, ba, dump),
                               torch.where(changed, bb, dump)], 1), True)
    awake0 = bodies.awake | hit[:, :nb]
    contacts = dataclasses.replace(
        contacts, m_type=manifold.mtype, m_local_point=manifold.local_point,
        m_local_normal=manifold.local_normal, m_points=manifold.points,
        m_ids=manifold.ids, m_count=torch.where(sensor, 0, manifold.count),
        normal_impulse=matched(contacts.normal_impulse),
        tangent_impulse=matched(contacts.tangent_impulse), touching=touching)

    non_static = bodies.exists & ~bodies.is_static & bodies.enabled
    dyn = bodies.is_dynamic & bodies.enabled
    solvable = touching & ~sensor
    if enabled is not None:
        solvable = solvable & enabled
    return _PreTouch(
        contacts=contacts, awake0=awake0, non_static=non_static,
        solvable=solvable, dyn_a=take(dyn, ba),
        dyn_b=take(dyn, bb),
        begin_touch=pair_exists & touching & ~state.contacts.touching,
        end_touch=pair_exists & ~touching & state.contacts.touching)


def _cc_active_of(pt: _PreTouch, labels, ba, bb):
    """Awake propagation + the solvable-and-someone-awake-dynamic mask."""
    awake = islands.propagate_awake(pt.awake0, labels, pt.non_static)
    cc_active = pt.solvable & ((pt.dyn_a & take(awake, ba))
                               | (pt.dyn_b & take(awake, bb)))
    return awake, cc_active


def _pre_finish(state: State, pt: _PreTouch, labels, awake, cc_active,
                color, color_overflow, dt: float, warm_starting: bool,
                ba, bb) -> _PreSolve:
    """Velocity integration + constraint init + warm start."""
    bodies = state.bodies
    contacts = pt.contacts
    solve_mask = awake & pt.non_static
    # sweep start for CCD / broad-phase sweep (b2Island.cpp:203-207)
    c0 = torch.where(solve_mask[..., None], bodies.c, bodies.c0)
    a0 = torch.where(solve_mask, bodies.a, bodies.a0)
    v, w = integrate.integrate_velocities(
        dataclasses.replace(bodies, awake=awake), state.gravity, dt, solve_mask)
    cc = csolver.init_contact_constraints(
        contacts, state.fixtures, bodies, bodies.c, bodies.a, v, w, cc_active)
    dt_ratio = (state.inv_dt0 * dt if dt > 0
                else torch.zeros_like(state.inv_dt0))
    bs = torch.stack([v[..., 0], v[..., 1], w], 1)
    if warm_starting:
        ni_it = dt_ratio[:, None, None] * contacts.normal_impulse
        ti_it = dt_ratio[:, None, None] * contacts.tangent_impulse
        bs = csolver.warm_start(cc, ni_it, ti_it, bs)
    else:
        ni_it = torch.zeros_like(contacts.normal_impulse)
        ti_it = torch.zeros_like(contacts.tangent_impulse)
    return _PreSolve(
        contacts=contacts, awake=awake, labels=labels,
        non_static=pt.non_static, solve_mask=solve_mask, c0=c0, a0=a0,
        cc=cc, color=color, color_overflow=color_overflow, ni_it=ni_it,
        ti_it=ti_it, bs=bs, ba=ba, bb=bb, dyn_a=pt.dyn_a, dyn_b=pt.dyn_b,
        cc_active=cc_active, dt_ratio=dt_ratio, begin_touch=pt.begin_touch,
        end_touch=pt.end_touch)


def middle_inputs(pre: _PreSolve, c, a, max_colors: int):
    """The solve middle's arguments (ops/solve_middle.py): slot-order
    constraint rows, the color-major packing (the dest/rank compaction of
    the JAX package, world.py:575-590, as an integer permutation), the
    dynamic-endpoint flags and the body planes."""
    cc, color = pre.cc, pre.color
    nw, nc = color.shape
    lane_ok = cc.active & (color >= 0)
    slot = torch.arange(nc, device=color.device)
    key = torch.where(lane_ok, color.long() * nc + slot, max_colors * nc)
    perm = torch.sort(key, dim=1, stable=True).indices.to(torch.int32)
    sizes = torch.zeros((nw, max_colors), dtype=torch.int32, device=color.device)
    sizes.scatter_add_(1, color.clamp_min(0).long(), lane_ok.to(torch.int32))
    color_start = torch.cat([torch.zeros_like(sizes[:, :1]),
                             torch.cumsum(sizes, 1, dtype=torch.int32)], 1)
    dyn_ab = pre.dyn_a.to(torch.uint8) | (pre.dyn_b.to(torch.uint8) << 1)
    blob = csolver.pack_cc_blob_t(cc, pre.ni_it, pre.ti_it)
    pos = torch.stack([c[..., 0], c[..., 1], a], 1)
    return (blob, perm.contiguous(), color_start.contiguous(),
            dyn_ab.contiguous(), pre.bs.contiguous(), pos.contiguous(),
            pre.solve_mask.contiguous())


def _mids_of(pre: _PreSolve, vel, pos, aux, **joint_results) -> _Mids:
    """Body planes and slot-order aux rows as the post phase takes them;
    impulses of lanes not solved this step keep their values."""
    solved = pre.cc.active & (pre.color >= 0)
    ni_it = torch.where(solved[..., None], aux[:, 0:2].transpose(1, 2), pre.ni_it)
    ti_it = torch.where(solved[..., None], aux[:, 2:4].transpose(1, 2), pre.ti_it)
    min_sep = torch.where(solved, aux[:, 4], 0.0)
    return _Mids(ni_it=ni_it, ti_it=ti_it,
                 c=pos[:, 0:2].transpose(1, 2).contiguous(), a=pos[:, 2],
                 v=vel[:, 0:2].transpose(1, 2).contiguous(), w=vel[:, 2],
                 min_sep=min_sep, **joint_results)


def _solve_middle_b(c, a, pre: _PreSolve, dt: float, velocity_iterations,
                    position_iterations, max_colors, middle) -> _Mids:
    """Contact velocity/position iterations over a batch of joint-free
    worlds via the solve middle."""
    args = middle_inputs(pre, c, a, max_colors)
    vel, pos, aux = middle(*args, dt, velocity_iterations, position_iterations)
    return _mids_of(pre, vel, pos, aux)


def _rows(lin, ang):
    """(W, N, 2) and (W, N) as the kernels' (W, 3, N) planes."""
    return torch.stack([lin[..., 0], lin[..., 1], ang], 1)


def _solve_sandwich_b(states: State, pre: _PreSolve, dt: float,
                      velocity_iterations, position_iterations, warm_starting,
                      max_colors, sandwich: Sandwich, syncs: HostSyncs) -> _Mids:
    """The solve middle of worlds with joints, in the reference island
    order (b2Island.cpp:268-335): per velocity iteration the joints then
    one contact sweep, per position iteration one contact sweep then the
    joints. The packed contact table persists between the sweeps'
    launches; the joint passes are PyTorch (joints/solver.py)."""
    bodies = states.bodies
    blob, perm, color_start, dyn_ab, vel, _, _ = middle_inputs(
        pre, bodies.c, bodies.a, max_colors)
    layout = (perm, color_start, dyn_ab)
    packed = sandwich.pack(blob, perm, color_start)
    v, w = vel[:, 0:2].transpose(1, 2), vel[:, 2]
    jdata, jstate = init_joints(
        states.joints, bodies, pre.awake, v, w, dt, pre.dt_ratio, warm_starting,
        bodies.capacity, max_colors, syncs=syncs)
    v, w = warm_start_joints(jdata, jstate, v, w)
    for _ in range(velocity_iterations):
        jstate, v, w = solve_joint_velocity(jdata, jstate, v, w, dt)
        vel = sandwich.vel_iter(packed, *layout, _rows(v, w).contiguous())
        v, w = vel[:, 0:2].transpose(1, 2), vel[:, 2]
    c, a, v, w = integrate.integrate_positions(bodies.c, bodies.a, v, w, dt,
                                               pre.solve_mask)
    jok = torch.ones_like(pre.solve_mask)
    for _ in range(position_iterations):
        pos = sandwich.pos_iter(packed, *layout, _rows(c, a).contiguous())
        c, a, jok = solve_joint_position(
            jdata, jstate, pos[:, 0:2].transpose(1, 2), pos[:, 2])
    aux = sandwich.unpack(packed, perm, color_start)
    return _mids_of(pre, _rows(v, w), _rows(c, a), aux, jok=jok,
                    joints=store_joint_impulses(states.joints, jstate))


def _post_sleep_sync(state: State, pre: _PreSolve, dt: float, allow_sleep,
                     mids: _Mids):
    """Impulse store, sleep, fixture synchronize. Returns the state
    before the pair refresh and the per-fixture `moved` mask."""
    bodies = state.bodies
    nw, nb = bodies.body_type.shape
    contacts = dataclasses.replace(pre.contacts, normal_impulse=mids.ni_it,
                                   tangent_impulse=mids.ti_it)
    # per-island convergence for sleep (positionSolved analog)
    contact_ok = mids.min_sep >= -3.0 * settings.LINEAR_SLOP
    ns_a = take(pre.non_static, pre.ba)
    c_label = take(pre.labels, torch.where(ns_a, pre.ba, pre.bb)).long()
    island_ok = torch.ones((nw, nb + 1), dtype=torch.bool, device=c_label.device)
    island_ok.scatter_(1, torch.where(pre.cc_active & ~contact_ok, c_label, nb),
                       False)
    if mids.jok is not None:
        island_ok.scatter_(1, torch.where(mids.jok, nb, pre.labels.long()), False)

    bodies = dataclasses.replace(
        bodies, c=mids.c, a=mids.a, c0=pre.c0, a0=pre.a0, v=mids.v, w=mids.w,
        awake=pre.awake, force=torch.zeros_like(bodies.force),
        torque=torch.zeros_like(bodies.torque))
    new_awake, sleep_time = islands.update_sleep(
        bodies, pre.labels, island_ok[:, :nb], dt, allow_sleep)
    fell_asleep = bodies.awake & ~new_awake
    bodies = dataclasses.replace(
        bodies, awake=new_awake, sleep_time=sleep_time,
        v=torch.where(fell_asleep[..., None], 0.0, bodies.v),
        w=torch.where(fell_asleep, 0.0, bodies.w))

    # synchronize (swept fat AABBs)
    p0, q0 = body_xf(pre.c0, pre.a0, bodies.local_center)
    p1, q1 = body_xf(bodies.c, bodies.a, bodies.local_center)
    fx = state.fixtures
    fb = fx.body.clamp_min(0).long()
    aabb_lo, aabb_hi, moved = broadphase.synchronize(
        fx, take(p0, fb), take(q0, fb), take(p1, fb), take(q1, fb))
    fx = dataclasses.replace(fx, aabb_lo=aabb_lo, aabb_hi=aabb_hi)
    if dt > 0:
        inv_dt0 = torch.full_like(state.inv_dt0,
                                  float(np.float32(1.0) / np.float32(dt)))
    else:
        inv_dt0 = state.inv_dt0
    state_mid = dataclasses.replace(
        state, bodies=bodies, fixtures=fx, contacts=contacts, inv_dt0=inv_dt0,
        joints=state.joints if mids.joints is None else mids.joints)
    return state_mid, moved


def _post_solve_b(states: State, pre: _PreSolve, dt: float, allow_sleep,
                  mids: _Mids, syncs: HostSyncs,
                  filter_fn=None) -> Tuple[State, Events]:
    """Sleep/sync, then the pair-table refresh of the worlds in which a
    fixture escaped its fat AABB: elsewhere the overlap set is unchanged
    and the broad phase is skipped (b2BroadPhase.h:211-267), for the whole
    batch when no world needs it. A world's table and its pair overflow
    come from its own refresh only, so no world depends on its batch."""
    nf = states.fixtures.capacity
    nc = states.contacts.capacity
    nw = states.n_worlds
    state_mid, moved = _post_sleep_sync(states, pre, dt, allow_sleep, mids)
    sm_c = state_mid.contacts
    zw = torch.zeros(nw, dtype=torch.int32, device=moved.device)
    contacts = dataclasses.replace(sm_c, toi_count=torch.zeros_like(sm_c.toi_count))
    pair_overflow = zw
    refresh = moved.any(1) | states.pairs_dirty
    if syncs.flag(refresh.any()):
        syncs.event("pairs.refreshes")
        with syncs.span("pair_refresh"):
            f_a, f_b, overflow = broadphase.find_pairs(state_mid, nc, filter_fn, syncs)
            pair_overflow = torch.where(refresh, overflow, 0)
            # identity gate: a world whose pair list is unchanged keeps its
            # table
            changed = refresh & ((f_a != sm_c.f_a).any(1) | (f_b != sm_c.f_b).any(1))
            if syncs.flag(changed.any()):
                contacts = where_worlds(changed, broadphase.carry_over_contacts(
                    sm_c, f_a, f_b, nf), contacts)
    new_state = dataclasses.replace(
        state_mid, contacts=contacts,
        pairs_dirty=torch.zeros_like(states.pairs_dirty))
    events = Events(
        begin_touch=pre.begin_touch, end_touch=pre.end_touch,
        f_a=states.contacts.f_a, f_b=states.contacts.f_b,
        pair_overflow=pair_overflow,
        color_overflow=pre.color_overflow.to(torch.int32), toi_overflow=zw,
        normal_impulse=mids.ni_it, tangent_impulse=mids.ti_it,
        touching=pre.contacts.touching,
        toi_begin=torch.zeros_like(contacts.touching),
        toi_f_a=contacts.f_a, toi_f_b=contacts.f_b,
        toi_normal_impulse=torch.zeros_like(contacts.normal_impulse),
        toi_tangent_impulse=torch.zeros_like(contacts.tangent_impulse), host_syncs=0)
    return new_state, events


# --------------------------------------------------------------------------
# continuous collision (the TOI phase)
# --------------------------------------------------------------------------


def _min_at(n, idx, vals):
    """(W, n) minimum of vals (W, M) scattered at idx (W, M), +inf where
    nothing lands (scatter_min_scalar)."""
    out = torch.full((idx.shape[0], n), math.inf, dtype=vals.dtype,
                     device=vals.device)
    return out.scatter_reduce_(1, idx.long(), vals, "amin")


def _any_at(n, idx, flags):
    """(W, n) bool: some lane with a True flag has its index here."""
    out = torch.zeros((idx.shape[0], n + 1), dtype=torch.bool, device=idx.device)
    out.scatter_(1, torch.where(flags, idx.long(), n), True)
    return out[:, :n]


def _shape_rows(fx: Fixtures, idx, rmax):
    """Per-lane fixture data at fixture slots idx (W, K)."""
    return dict(verts=take(fx.verts, idx), normals=take(fx.normals, idx),
                nverts=take(fx.nverts, idx), radius=take(fx.radius, idx),
                friction=take(fx.friction, idx),
                restitution=take(fx.restitution, idx),
                shape_type=take(fx.shape_type, idx), rmax=take(rmax, idx),
                ghosts=take(fx.ghosts, idx))


def _advance_sweep(alpha, c0, c, a0, a, alpha0):
    """b2Sweep::Advance of a sweep (c0, a0 at alpha0 -> c, a) to `alpha`:
    the new sweep start."""
    beta = (alpha - alpha0) / torch.where(alpha0 < 1.0, 1.0 - alpha0, 1.0)
    return c0 + beta[..., None] * (c - c0), a0 + beta * (a - a0)


def _sweep_rows(lc, c0, c, a0, a):
    """(W, K) lanes' sweeps as the time-of-impact kernel's (8, L) rows."""
    return torch.stack([lc[..., 0], lc[..., 1], c0[..., 0], c0[..., 1],
                        c[..., 0], c[..., 1], a0, a], 0).reshape(8, -1)


def _mix(contacts: Contacts, s_a, s_b, slots):
    """Friction and restitution of lanes at contact slots, with the
    per-contact overrides (b2MixFriction, b2MixRestitution)."""
    fric = torch.sqrt(s_a["friction"] * s_b["friction"])
    fo = take(contacts.friction_override, slots)
    rest = torch.maximum(s_a["restitution"], s_b["restitution"])
    ro = take(contacts.restitution_override, slots)
    return torch.where(fo >= 0.0, fo, fric), torch.where(ro >= 0.0, ro, rest)


def _flat(x):
    return x.reshape((-1,) + x.shape[2:])


def _collide_lanes(kind, sa, pA, qA, sb, pB, qB, kinds) -> nph.Manifold:
    """nph.collide over (W, K) lanes."""
    nw = kind.shape[0]

    def rows(s):
        return nph.ShapeRows(*(_flat(s[k]) for k in
                               ("verts", "normals", "nverts", "ghosts", "radius")))

    man = nph.collide(_flat(kind), rows(sa), _flat(pA), _flat(qA),
                      rows(sb), _flat(pB), _flat(qB), kinds)
    return nph.Manifold(*(x.reshape((nw, -1) + x.shape[1:]) for x in man))


def _integrate_lane(cx, cy, a_, vx, vy, w_, movable, h):
    """The rest of the step for a TOI body (b2Island::SolveTOI's
    integration, b2Island.cpp:489-523) with the translation/rotation
    clamps."""
    t2 = h * h * (vx ** 2 + vy ** 2)
    rat = torch.where(t2 > settings.MAX_TRANSLATION_SQUARED,
                      settings.MAX_TRANSLATION / torch.sqrt(torch.clamp_min(t2, 1e-30)),
                      1.0)
    vx = vx * rat
    vy = vy * rat
    rot = h * w_
    ratr = torch.where(rot * rot > settings.MAX_ROTATION_SQUARED,
                       settings.MAX_ROTATION / torch.abs(torch.where(rot == 0.0, 1.0, rot)),
                       1.0)
    w_ = w_ * ratr
    return (torch.where(movable, cx + h * vx, cx), torch.where(movable, cy + h * vy, cy),
            torch.where(movable, a_ + h * w_, a_), vx, vy, w_)


def _body_rmax(fx: Fixtures, nb):
    """Per-fixture and per-body bounding radius about the body origin."""
    valid8 = torch.arange(8, device=fx.nverts.device) < fx.nverts[..., None]
    vlen = torch.sqrt((fx.verts ** 2).sum(-1))
    f_rmax = torch.where(valid8, vlen, 0.0).amax(-1) + fx.radius
    idx = torch.where(fx.body >= 0, fx.body, nb).long()
    b_rmax = torch.zeros((f_rmax.shape[0], nb + 1), device=f_rmax.device)
    b_rmax.scatter_reduce_(1, idx, torch.where(fx.body >= 0, f_rmax, 0.0), "amax")
    return f_rmax, b_rmax[:, :nb]


def _solve_toi_b(states: State, dt: float, velocity_iterations: int,
                 toi_rounds: int, kinds, toi_capacity: int, toi_neighbors: bool,
                 toi, syncs: HostSyncs, enabled=None, pre_solve_fn=None,
                 moved=None):
    """Continuous physics over a batch of worlds (b2World::SolveTOI,
    b2World.cpp:1026-1093), as the JAX package restructures it
    (box2d_mt_tpu/world.py:981-1946):

      * candidate compaction: TOI candidates (b2Contact::IsToiCandidate)
        with an awake non-static endpoint, actives first in slot order, the
        first `toi_capacity` per world; the rest count in toi_overflow;
      * rounds: every running lane's time of impact (`toi`, the kernel),
        then all disjoint earliest events at once (per non-static body the
        earliest alpha wins, ties by contact slot);
      * the sub-step of each selected pair: advance to alpha, re-evaluate
        the manifold (restore-and-skip when empty), pull in the TOI bodies'
        other contacts as a mini island (`toi_neighbors`), 20 TOI position
        passes, a velocity solve without warm start, the rest of the step,
        and the commit of kept dynamic neighbors.

    The deviations PARITY.md lists (TOI mini island, no pair refresh after
    TOI moves, TOI begin events on the refreshed table's slots) are
    reproduced as they are. The sub-steps' impulses come out too, the
    PostSolve report of b2Island::SolveTOI. With a PreSolve hook,
    `enabled` (W, C) is the contacts' enabled flag on the refreshed table
    (the collide pass's answer): a disabled pair is no candidate and no
    mini-island neighbor (b2World.cpp:1534-1541, :920-928), and the hook
    is consulted again at every sub-step on the lanes' fresh manifolds,
    with the bodies at their TOI poses (b2World.cpp:860-874). `moved` (W,)
    marks the worlds past the motion pre-gate (None: all): a world the
    pre-gate would skip finds no event here and reports no overflow, as
    when it is stepped alone. Returns (state, toi_overflow (W,), toi_begin
    (W, C), the impulses (W, C, 4))."""
    bodies, fx, contacts = states.bodies, states.fixtures, states.contacts
    nw, nb = bodies.body_type.shape
    nc = contacts.capacity
    dev = bodies.c.device
    kcap = min(toi_capacity, nc)
    static, dynamic = settings.STATIC_BODY, settings.DYNAMIC_BODY

    ia = contacts.f_a.clamp_min(0).long()
    ib = contacts.f_b.clamp_min(0).long()
    pair_exists = contacts.f_a >= 0
    # ---- candidacy (b2Contact::IsToiCandidate + the awake gate,
    # b2World.cpp:1534-1541)
    ba = take(fx.body, ia).clamp_min(0).long()
    bb = take(fx.body, ib).clamp_min(0).long()
    sensor = take(fx.is_sensor, ia) | take(fx.is_sensor, ib)
    thick = take(fx.thick_shape, ia) | take(fx.thick_shape, ib)
    type_a = take(bodies.body_type, ba)
    type_b = take(bodies.body_type, bb)
    bul_a = take(bodies.bullet, ba)
    bul_b = take(bodies.bullet, bb)
    both_dyn = (type_a == dynamic) & (type_b == dynamic)
    awake_pair = ((take(bodies.awake, ba) & (type_a != static))
                  | (take(bodies.awake, bb) & (type_b != static)))
    cand = pair_exists & ~sensor & ((bul_a | bul_b) | (~both_dyn & ~thick))
    if enabled is not None:
        cand = cand & enabled
    active0 = cand & awake_pair

    # ---- compaction: the r-th active slot in slot order goes to lane r;
    # lanes past the active count take slot 0 and stay off
    c_rank = torch.cumsum(active0.to(torch.int32), 1) - 1
    n_active = active0.sum(1)
    slot_iota = torch.arange(nc, device=dev)
    sel = torch.zeros((nw, kcap + 1), dtype=torch.long, device=dev)
    sel.scatter_(1, torch.where(active0 & (c_rank < kcap), c_rank, kcap).long(),
                 slot_iota.expand(nw, nc))
    sel = sel[:, :kcap]
    lane_iota = torch.arange(kcap, device=dev)
    lane_on = take(active0, sel) & (lane_iota < n_active[:, None])
    toi_overflow = (n_active - lane_on.sum(1)).to(torch.int32)
    if moved is not None:
        toi_overflow = torch.where(moved, toi_overflow, 0)
    zero_alpha = dataclasses.replace(bodies, alpha0=torch.zeros_like(bodies.alpha0))
    # the sub-steps' impulses by slot: normal 0-1, tangent 2-3; column C
    # takes the lanes that write nothing
    toi_imp = torch.zeros((nw, nc + 1, 4), device=dev)
    if not syncs.flag(lane_on.any()):
        return (dataclasses.replace(states, bodies=zero_alpha), toi_overflow,
                torch.zeros_like(contacts.touching), toi_imp[:, :nc])

    kba, kbb = take(ba, sel), take(bb, sel)
    ns_a = take(type_a, sel) != static
    ns_b = take(type_b, sel) != static
    dyn_a = take(type_a, sel) == dynamic
    dyn_b = take(type_b, sel) == dynamic
    kbab = torch.cat([kba, kbb], 1)

    f_rmax, _ = _body_rmax(fx, nb)
    sa = _shape_rows(fx, take(ia, sel), f_rmax)
    sb = _shape_rows(fx, take(ib, sel), f_rmax)
    kind = nph.contact_kind(sa["shape_type"], sb["shape_type"])
    lane_ts = take(contacts.tangent_speed, sel)

    fric, rest = _mix(contacts, sa, sb, sel)
    mA = torch.where(dyn_a, take(bodies.inv_mass, kba), 0.0)
    iA = torch.where(dyn_a, take(bodies.inv_inertia, kba), 0.0)
    lcA = take(bodies.local_center, kba)
    mB = torch.where(dyn_b, take(bodies.inv_mass, kbb), 0.0)
    iB = torch.where(dyn_b, take(bodies.inv_inertia, kbb), 0.0)
    lcB = take(bodies.local_center, kbb)
    verts_a = _flat(sa["verts"]).permute(2, 1, 0).contiguous()
    verts_b = _flat(sb["verts"]).permute(2, 1, 0).contiguous()
    t_max = torch.ones(nw * kcap, device=dev)

    # packed body state: [cx, cy, a, c0x, c0y, a0, alpha0, vx, vy, w, awake]
    bp = torch.cat([bodies.c, bodies.a[..., None], bodies.c0, bodies.a0[..., None],
                    torch.zeros((nw, nb, 1), device=dev), bodies.v,
                    bodies.w[..., None], bodies.awake.to(torch.float32)[..., None]], -1)
    lane_tc0 = take(contacts.toi_count, sel).to(torch.float32)
    lane_tc = lane_tc0
    lane_touch = torch.zeros((nw, kcap), dtype=torch.bool, device=dev)
    ntouch = torch.zeros((nw, nc), dtype=torch.bool, device=dev)

    for _ in range(toi_rounds):
        with syncs.span("toi_round"):
            ga, gb = take(bp, kba), take(bp, kbb)
            cA, aA, c0A, a0A, al0A = ga[..., 0:2], ga[..., 2], ga[..., 3:5], ga[..., 5], ga[..., 6]
            vA, wA, awA = ga[..., 7:9], ga[..., 9], ga[..., 10] > 0.5
            cB, aB, c0B, a0B, al0B = gb[..., 0:2], gb[..., 2], gb[..., 3:5], gb[..., 5], gb[..., 6]
            vB, wB, awB = gb[..., 7:9], gb[..., 9], gb[..., 10] > 0.5
            blocked = lane_tc >= settings.MAX_SUB_STEPS
            al0 = torch.maximum(al0A, al0B)

            # sync both sweeps to the later alpha0 (the b2TimeOfImpact preamble)
            c0As, a0As = _advance_sweep(al0, c0A, cA, a0A, aA, al0A)
            c0Bs, a0Bs = _advance_sweep(al0, c0B, cB, a0B, aB, al0B)
            # relative motion bound over the remaining window: a pair moving
            # less than half a slop cannot tunnel this step
            dmov = (cA - c0As) - (cB - c0Bs)
            mb = (torch.sqrt((dmov ** 2).sum(-1)) + torch.abs(aA - a0As) * sa["rmax"]
                  + torch.abs(aB - a0Bs) * sb["rmax"])
            awake_now = (awA & ns_a) | (awB & ns_b)
            run = (lane_on & ~blocked & awake_now & (al0 < 1.0)
                   & (mb > 0.5 * settings.LINEAR_SLOP))

            syncs.event("toi.rounds")
            tstate, t = toi(verts_a, _flat(sa["nverts"]), _flat(sa["radius"]),
                            _sweep_rows(lcA, c0As, cA, a0As, aA),
                            verts_b, _flat(sb["nverts"]), _flat(sb["radius"]),
                            _sweep_rows(lcB, c0Bs, cB, a0Bs, aB), t_max, _flat(run).contiguous())
            tstate = tstate.reshape(nw, kcap)
            t = t.reshape(nw, kcap)
            alpha = torch.where(tstate == distance.TOI_TOUCHING,
                                torch.clamp_max(al0 + (1.0 - al0) * t, 1.0), 1.0)
            alpha = torch.where(run, alpha, math.inf)
            has_ev = alpha < 1.0 - 10.0 * 1.1920929e-7

            # ---- disjoint selection: per non-static body the earliest alpha
            # wins, ties by canonical contact slot (ToiLessThan analog)
            eidx = torch.cat([torch.where(ns_a & has_ev, kba, nb),
                              torch.where(ns_b & has_ev, kbb, nb)], 1)
            av = torch.where(has_ev, alpha, math.inf)
            amin = _min_at(nb + 1, eidx, torch.cat([av, av], 1))
            win1 = (has_ev & (~ns_a | (alpha <= take(amin, kba)))
                    & (~ns_b | (alpha <= take(amin, kbb))))
            selp = sel.to(torch.float32)
            sv = torch.where(win1, selp, math.inf)
            eidx2 = torch.cat([torch.where(ns_a & win1, kba, nb),
                               torch.where(ns_b & win1, kbb, nb)], 1)
            smin = _min_at(nb + 1, eidx2, torch.cat([sv, sv], 1))
            selwin = (win1 & (~ns_a | (selp == take(smin, kba)))
                      & (~ns_b | (selp == take(smin, kbb))))
            alpha_s = torch.where(selwin, alpha, 1.0)
            lane_tc = lane_tc + selwin.to(torch.float32)
            if not syncs.flag(selwin.any()):
                break
        with syncs.span("toi_substep"):
            # ---- the sub-step: advance both bodies of each selected pair to
            # its alpha and re-evaluate the manifold there
            cAn, aAn = _advance_sweep(alpha_s, c0A, cA, a0A, aA, al0A)
            cBn, aBn = _advance_sweep(alpha_s, c0B, cB, a0B, aB, al0B)
            qA1 = rot_from_angle(aAn)
            qB1 = rot_from_angle(aBn)
            man = _collide_lanes(kind, sa, cAn - rot_vec(qA1, lcA), qA1,
                                 sb, cBn - rot_vec(qB1, lcB), qB1, kinds)
            hit = man.count > 0
            if pre_solve_fn is not None:
                # the reference re-runs Contact::Update -> PreSolve at every TOI
                # sub-step (b2World.cpp:871-874): the hook sees each selected
                # lane's fresh manifold in its slot, and a lane it disables
                # consumes its event without a sub-step, as an empty manifold
                at_toi = _toi_pose_state(states, bp, kbab, torch.cat([
                    selwin & ns_a, selwin & ns_b], 1), torch.cat([
                    torch.cat([cAn, aAn[..., None]], -1),
                    torch.cat([cBn, aBn[..., None]], -1)], 1), alpha_s)
                hit = hit & take(_substep_enabled(at_toi, pre_solve_fn, man, hit, sel,
                                                  selwin, ba, bb), sel)
            # no manifold at the TOI (or disabled): restore (skip every write)
            # and mark the pair consumed (b2World.cpp:928-940)
            solve = selwin & hit

            # ---- the position passes, the velocity constraints at the solved
            # pose and the velocity iterations, mini islands in (K8 on a card)
            island = (_MiniIsland(
                states, bp, ia, ib, ba, bb, type_a, type_b, bul_a, bul_b,
                pair_exists, sensor, f_rmax, sel, selwin, solve, kba, kbab,
                ns_a, ns_b, alpha_s, cAn, aAn, cBn, aBn, kinds, enabled)
                if toi_neighbors else None)
            lanes = (solve.reshape(-1), *_flat_rows(
                [man.mtype, man.count], _manifold_rows(man),
                [mA, mB, iA, iB, lcA[..., 0], lcA[..., 1], lcB[..., 0], lcB[..., 1],
                 sa["radius"], sb["radius"]], [fric, rest, lane_ts],
                [cAn[..., 0], cAn[..., 1], aAn, cBn[..., 0], cBn[..., 1], aBn],
                [vA[..., 0], vA[..., 1], wA, vB[..., 0], vB[..., 1], wB]))
            nbrs = island.rows if island is not None else _no_neighbors(nw * kcap, dev)
            pose, vel, imp, nb_imp, nb_vel = toi_substep_passes(
                *lanes, *nbrs, iterations=velocity_iterations, syncs=syncs)
            cax, cay, aa_, cbx, cby, ab_ = pose.reshape(6, nw, kcap)
            vax, vay, wa_, vbx, vby, wb_ = vel.reshape(6, nw, kcap)
            wl = torch.arange(nw, device=dev)[:, None]
            toi_imp[wl, torch.where(solve, sel, nc)] = imp.reshape(4, nw, kcap).permute(1, 2, 0)
            if island is not None:
                toi_imp[wl, torch.where(island.n_keep, island.nsel, nc)] = nb_imp.reshape(
                    4, nw, kcap).permute(1, 2, 0)

            # ---- complete the remainder of the step for the pair
            h = (1.0 - torch.where(selwin, alpha_s, 1.0)) * dt
            cAfx, cAfy, aAf, vax, vay, wa_ = _integrate_lane(cax, cay, aa_, vax, vay, wa_, ns_a, h)
            cBfx, cBfy, aBf, vbx, vby, wb_ = _integrate_lane(cbx, cby, ab_, vbx, vby, wb_, ns_b, h)

            def delta(on, cfx, cfy, af, c0fx, c0fy, a0f, vfx, vfy, wf, c_o, a_o, c0_o,
                      a0_o, al0_o, v_o, w_o, aw_o):
                d = torch.stack([
                    cfx - c_o[..., 0], cfy - c_o[..., 1], af - a_o,
                    c0fx - c0_o[..., 0], c0fy - c0_o[..., 1], a0f - a0_o,
                    alpha_s - al0_o, vfx - v_o[..., 0], vfy - v_o[..., 1], wf - w_o,
                    (~aw_o).to(torch.float32)], -1)
                return d * on.to(torch.float32)[..., None]

            # one scatter of body deltas (the selected pairs are disjoint on
            # non-static bodies, so add == set); leap of faith: the sweep
            # restarts at the position-solved pose
            dA = delta(solve & ns_a, cAfx, cAfy, aAf, cax, cay, aa_, vax, vay, wa_,
                       cA, aA, c0A, a0A, al0A, vA, wA, awA)
            dB = delta(solve & ns_b, cBfx, cBfy, aBf, cbx, cby, ab_, vbx, vby, wb_,
                       cB, aB, c0B, a0B, al0B, vB, wB, awB)
            bp = add_rows(bp, kbab, torch.cat([dA, dB], 1))
            if island is not None:
                bp, ntouch = island.commit(bp, ntouch, h, nb_vel.reshape(3, nw, kcap))
            lane_touch = lane_touch | solve

    # sub-step counts and TOI touches back to contact slots: a sub-step that
    # found a manifold makes the pair touching now and fires BeginContact
    # this step (b2World::StepSolveTOI's Contact::Update)
    tc_add = add_rows(torch.zeros((nw, nc, 2), device=dev), sel,
                      torch.stack([lane_tc - lane_tc0,
                                   lane_touch.to(torch.float32)], -1))
    toi_touch = (tc_add[..., 1] > 0.5) | ntouch
    contacts2 = dataclasses.replace(
        contacts, toi_count=contacts.toi_count + tc_add[..., 0].to(torch.int32),
        touching=contacts.touching | toi_touch)
    bodies2 = dataclasses.replace(
        zero_alpha, c=bp[..., 0:2].contiguous(), a=bp[..., 2].contiguous(),
        c0=bp[..., 3:5].contiguous(), a0=bp[..., 5].contiguous(),
        v=bp[..., 7:9].contiguous(), w=bp[..., 9].contiguous(), awake=bp[..., 10] > 0.5)
    return (dataclasses.replace(states, bodies=bodies2, contacts=contacts2),
            toi_overflow, toi_touch & ~contacts.touching, toi_imp[:, :nc])


def _toi_pose_state(states: State, bp, kbab, moved, pose, alpha_s) -> State:
    """The state a PreSolve hook sees at a TOI sub-step: every body as the
    TOI phase has left it so far (bp), the selected pairs' non-static
    bodies advanced to their TOI pose (b2Body::Advance: sweep start =
    center = the pose, alpha0 = alpha), as the reference's bodies stand
    when Contact::Update runs PreSolve there (b2World.cpp:860-874)."""
    nw, nb = bp.shape[:2]
    slot = torch.where(moved, kbab, nb)
    w = torch.arange(nw, device=bp.device)[:, None]
    out = torch.cat([bp, bp[:, :1]], 1)
    cur = out[w, slot]
    adv = torch.cat([pose, pose, torch.cat([alpha_s, alpha_s], 1)[..., None]], -1)
    out[w, slot] = torch.where(moved[..., None], torch.cat([adv, cur[..., 7:]], -1), cur)
    out = out[:, :nb]
    return dataclasses.replace(states, bodies=dataclasses.replace(
        states.bodies, c=out[..., 0:2], a=out[..., 2], c0=out[..., 3:5], a0=out[..., 5],
        alpha0=out[..., 6], v=out[..., 7:9], w=out[..., 9], awake=out[..., 10] > 0.5))


def _substep_enabled(states: State, pre_solve_fn, man: nph.Manifold, hit, sel,
                     selwin, ba, bb):
    """The hook's `enabled` (W, C) at a TOI sub-step: the selected lanes'
    manifolds and touches scattered into their slots, every other slot as
    the table holds it."""
    c = states.contacts
    nc = c.capacity
    slot = torch.where(selwin, sel, nc)

    def lane_to_slot(cur, lane_val):
        out = torch.cat([cur, cur[:, :1]], 1)
        w = torch.arange(cur.shape[0], device=cur.device)[:, None]
        out[w, slot] = lane_val.to(cur.dtype)
        return out[:, :nc]

    man_slot = nph.Manifold(*(lane_to_slot(old, new)
                              for old, new in zip((c.m_type, c.m_local_point,
                                                   c.m_local_normal, c.m_points, c.m_ids,
                                                   c.m_count), man)))
    view = _table_view(states, man_slot, ba, bb, lane_to_slot(c.touching, hit))
    enabled, _ = _hook_out(pre_solve_fn(states, view), c.touching)
    return torch.ones_like(c.touching) if enabled is None else enabled


class _MiniIsland:
    """The mini-island expansion of one TOI round (b2World.cpp:895-985):
    each solved pair pulls its TOI bodies' other contacts into the
    sub-solve as extra constraints. Admission follows the reference: the
    neighbor endpoint must be static or kinematic, or a bullet is involved
    (b2World.cpp:922-928); a neighbor is kept if its manifold at the
    advanced pose is not empty (b2World.cpp:938-961). `rows` are the
    neighbor arguments of the sub-step's passes
    (`ops.toi.toi_substep_passes`), each parent lane's kept neighbors in
    slot order; `commit` writes the passes' result back."""

    def __init__(self, states, bp, ia, ib, ba, bb, type_a, type_b, bul_a, bul_b,
                 pair_exists, sensor, f_rmax, sel, selwin, solve, kba, kbab,
                 ns_a, ns_b, alpha_s, cAn, aAn, cBn, aBn, kinds, enabled=None):
        bodies, fx, contacts = states.bodies, states.fixtures, states.contacts
        nw, nb = bodies.body_type.shape
        nc = contacts.capacity
        kcap = sel.shape[1]
        dev = bp.device
        dynamic = settings.DYNAMIC_BODY
        lane_f = torch.arange(kcap, device=dev, dtype=torch.float32).expand(nw, kcap)
        ends_on = torch.cat([ns_a & solve, ns_b & solve], 1)
        # body -> owning lane (solved pairs are body-disjoint)
        body_lane = _min_at(nb + 1, torch.where(ends_on, kbab, nb),
                            torch.cat([lane_f, lane_f], 1))[:, :nb]
        self.is_toi_body = body_lane < math.inf
        tb_a = take(self.is_toi_body, ba)
        tb_b = take(self.is_toi_body, bb)
        bullet = bul_a | bul_b
        adm_a = tb_a & ((type_b != dynamic) | bullet)
        adm_b = tb_b & ((type_a != dynamic) | bullet)
        sel_slot = _any_at(nc, sel, selwin)
        nbm = pair_exists & ~sensor & (adm_a | adm_b) & ~sel_slot
        if enabled is not None:
            nbm = nbm & enabled
        parent_f = torch.where(adm_a, take(body_lane, ba), take(body_lane, bb))
        nsel = torch.sort(torch.where(nbm, 0, 1), dim=1, stable=True).indices[:, :kcap]
        self.nsel = nsel
        nl_on = take(nbm, nsel)
        nba_, nbb_ = take(ba, nsel), take(bb, nsel)
        n_toi_a = take(adm_a, nsel)                 # the TOI body is endpoint A
        nparent = take(torch.where(torch.isfinite(parent_f), parent_f, 0.0),
                       nsel).clamp(0, kcap - 1).long()
        self.nparent = nparent
        n_dyn_a = take(type_a, nsel) == dynamic
        n_dyn_b = take(type_b, nsel) == dynamic
        sna = _shape_rows(fx, take(ia, nsel), f_rmax)
        snb = _shape_rows(fx, take(ib, nsel), f_rmax)
        nkind = nph.contact_kind(sna["shape_type"], snb["shape_type"])
        fric, rest = _mix(contacts, sna, snb, nsel)

        inv_m = lambda b: take(bodies.inv_mass, b)
        inv_i = lambda b: take(bodies.inv_inertia, b)
        # position pass: only the TOI body moves
        p_mass = (torch.where(n_toi_a & n_dyn_a, inv_m(nba_), 0.0),
                  torch.where(~n_toi_a & n_dyn_b, inv_m(nbb_), 0.0),
                  torch.where(n_toi_a & n_dyn_a, inv_i(nba_), 0.0),
                  torch.where(~n_toi_a & n_dyn_b, inv_i(nbb_), 0.0))
        # velocity pass: every island body keeps its real inverse mass
        v_mass = (torch.where(n_dyn_a, inv_m(nba_), 0.0),
                  torch.where(n_dyn_b, inv_m(nbb_), 0.0),
                  torch.where(n_dyn_a, inv_i(nba_), 0.0),
                  torch.where(n_dyn_b, inv_i(nbb_), 0.0))
        n_lcA = take(bodies.local_center, nba_)
        n_lcB = take(bodies.local_center, nbb_)
        self.o_dyn = torch.where(n_toi_a, n_dyn_b, n_dyn_a)

        # tentative advance of the neighbor endpoint to the parent's alpha
        # (b2Body::Advance; static endpoints are unaffected, c0 == c)
        self.n_alpha = take(alpha_s, nparent)
        self.other_body = torch.where(n_toi_a, nbb_, nba_)
        og = take(bp, self.other_body)
        o_al0 = og[..., 6]
        beta_o = (self.n_alpha - o_al0) / torch.where(o_al0 < 1.0, 1.0 - o_al0, 1.0)
        self.o_ce = og[..., 3:5] + beta_o[..., None] * (og[..., 0:2] - og[..., 3:5])
        self.o_ae = og[..., 5] + beta_o * (og[..., 2] - og[..., 5])
        self.og = og
        self.o_v, self.o_w = og[..., 7:9], og[..., 9]

        # evaluate at the parent lane's advanced pose
        side_a = torch.where(n_toi_a, nba_, nbb_) == take(kba, nparent)
        adv = torch.cat([cAn, aAn[..., None], cBn, aBn[..., None]], -1)
        own = take(adv, nparent)
        tpos = torch.where(side_a[..., None], own[..., 0:3], own[..., 3:6])
        a2 = n_toi_a[..., None]
        cA1 = torch.where(a2, tpos[..., 0:2], self.o_ce)
        aA1 = torch.where(n_toi_a, tpos[..., 2], self.o_ae)
        cB1 = torch.where(a2, self.o_ce, tpos[..., 0:2])
        aB1 = torch.where(n_toi_a, self.o_ae, tpos[..., 2])
        qA1, qB1 = rot_from_angle(aA1), rot_from_angle(aB1)
        nman = _collide_lanes(nkind, sna, cA1 - rot_vec(qA1, n_lcA), qA1,
                              snb, cB1 - rot_vec(qB1, n_lcB), qB1, kinds)
        self.n_keep = nl_on & (nman.count > 0) & take(solve, nparent)
        # each parent lane's kept neighbors in slot order: a span of `order`
        # (flat indices over the batch), with no host read
        lane = torch.arange(kcap, device=dev)
        key = torch.where(self.n_keep, nparent * kcap + lane, torch.iinfo(torch.int32).max)
        base = (torch.arange(nw, device=dev) * kcap)[:, None]
        order = torch.sort(key, dim=1).indices + base
        counts = torch.zeros((nw, kcap), dtype=torch.long, device=dev)
        counts.scatter_add_(1, nparent, self.n_keep.long())
        start = torch.cumsum(counts, 1) - counts + base
        i32 = lambda x: x.to(torch.int32).reshape(-1)
        self.rows = (
            torch.stack([start, counts]).to(torch.int32).reshape(2, -1),
            i32(torch.where(self.n_keep, nparent + base, -1)), i32(order),
            *_flat_rows([nman.mtype, nman.count, n_toi_a, side_a], _manifold_rows(nman),
                        [*p_mass, *v_mass, n_lcA[..., 0], n_lcA[..., 1], n_lcB[..., 0],
                         n_lcB[..., 1], sna["radius"], snb["radius"]],
                        [fric, rest, take(contacts.tangent_speed, nsel)],
                        [self.o_ce[..., 0], self.o_ce[..., 1], self.o_ae,
                         self.o_v[..., 0], self.o_v[..., 1], self.o_w]))

    def commit(self, bp, ntouch, h, o_vel):
        """Kept neighbor contacts become touching (b2World.cpp:955-967);
        kept dynamic neighbors are written back like the reference's island
        (b2Island.cpp:489-523): the sweep keeps the tentative advance, the
        velocity `o_vel` (3, W, K) comes from the island solve, the position
        is integrated over the rest of the step. A body that is itself a
        TOI body of this round is left to its own pair."""
        nw, nb = bp.shape[:2]
        kcap = self.nsel.shape[1]
        ntouch = ntouch | _any_at(ntouch.shape[1], self.nsel, self.n_keep)
        og = self.og
        commit = self.n_keep & self.o_dyn & ~take(self.is_toi_body, self.other_body)
        o_cfx, o_cfy, o_af, ovx, ovy, ow = _integrate_lane(
            self.o_ce[..., 0], self.o_ce[..., 1], self.o_ae, *o_vel, commit,
            take(h, self.nparent))
        # the pose commits once per body (its first kept slot); velocity
        # deltas add up over slots (a Jacobi sum of the impulses the
        # reference applies one after another)
        slot_f = torch.arange(kcap, device=bp.device, dtype=torch.float32).expand(nw, kcap)
        min_slot = _min_at(nb + 1, torch.where(commit, self.other_body, nb), slot_f)
        pf = (commit & (slot_f == take(min_slot, self.other_body))).to(torch.float32)
        cf = commit.to(torch.float32)
        d_pos = torch.stack([
            o_cfx - og[..., 0], o_cfy - og[..., 1], o_af - og[..., 2],
            self.o_ce[..., 0] - og[..., 3], self.o_ce[..., 1] - og[..., 4],
            self.o_ae - og[..., 5], self.n_alpha - og[..., 6]], -1) * pf[..., None]
        d_vel = torch.stack([ovx - self.o_v[..., 0], ovy - self.o_v[..., 1],
                             ow - self.o_w], -1) * cf[..., None]
        d_awk = (pf * (1.0 - og[..., 10]))[..., None]
        return add_rows(bp, self.other_body, torch.cat([d_pos, d_vel, d_awk], -1)), ntouch


def _manifold_rows(man: nph.Manifold):
    """A manifold's float fields as the sub-step passes' eight rows."""
    return [man.local_point[..., 0], man.local_point[..., 1], man.local_normal[..., 0],
            man.local_normal[..., 1], man.points[..., 0, 0], man.points[..., 0, 1],
            man.points[..., 1, 0], man.points[..., 1, 1]]


def _flat_rows(kind, *float_groups):
    """(W, K) fields as `ops.toi.toi_substep_passes` takes them: the
    integer fields `kind` as (rows, W * K) int32, each group of float
    fields as (rows, W * K) float32."""
    i32 = torch.stack([x.to(torch.int32) for x in kind]).reshape(len(kind), -1)
    return (i32, *(torch.stack(g).reshape(len(g), -1) for g in float_groups))


def _no_neighbors(n_lanes, dev):
    """The neighbor arguments of a sub-step without mini islands."""
    empty = lambda *shape, dtype=torch.float32: torch.empty(shape, dtype=dtype, device=dev)
    return (torch.zeros((2, n_lanes), dtype=torch.int32, device=dev),
            empty(0, dtype=torch.int32), empty(0, dtype=torch.int32),
            empty(4, 0, dtype=torch.int32), empty(8, 0), empty(14, 0), empty(3, 0),
            empty(6, 0))


def possible_kinds(state: State) -> tuple:
    """Host helper: the contact kinds this batch's shape types can produce
    (reads the fixture table once)."""
    st = state.fixtures.shape_type.reshape(-1).tolist()
    bd = state.fixtures.body.reshape(-1).tolist()
    types = {t for t, b in zip(st, bd) if b >= 0}
    c, e, p = settings.SHAPE_CIRCLE, settings.SHAPE_EDGE, settings.SHAPE_POLYGON
    kinds = []
    if c in types:
        kinds.append(nph.KIND_CIRCLES)
    if p in types and c in types:
        kinds.append(nph.KIND_POLYGON_CIRCLE)
    if p in types:
        kinds.append(nph.KIND_POLYGONS)
    if e in types and c in types:
        kinds.append(nph.KIND_EDGE_CIRCLE)
    if e in types and p in types:
        kinds.append(nph.KIND_EDGE_POLYGON)
    return tuple(kinds) if kinds else (nph.KIND_CIRCLES,)


def step_batched(states: State, dt, velocity_iterations: int = 8,
                 position_iterations: int = 3, warm_starting: bool = True,
                 allow_sleep: bool = True,
                 max_colors: int = settings.MAX_COLORS,
                 continuous: bool = True, toi_rounds: int = 8,
                 kinds=nph.ALL_KINDS, toi_capacity=None,
                 pre_solve_fn=None, filter_fn=None,
                 toi_neighbors: bool = True, *,
                 middle=None, toi=None, sandwich=None) -> Tuple[State, Events]:
    """One world-step over a batch of worlds (leading axis on every State
    leaf), with the JAX package's signature and semantics.

    `continuous=True` (the default, with toi_rounds > 0) runs the TOI
    phase after the pair refresh; `toi_capacity` (default max(32, C // 8))
    caps its lanes per world and `toi_neighbors` turns its mini islands on.
    `middle` and `toi` are the solve-middle and time-of-impact
    implementations (defaults `ops.solve_middle.solve_middle` and
    `ops.toi.time_of_impact_lanes`: the CUDA kernels for CUDA tensors, the
    plain versions for CPU tensors); `solve_middle_plain` and
    `time_of_impact_lanes_plain` run the plain path on a card. A batch
    with joint slots runs the sandwich instead of `middle`: `sandwich` is
    an `ops.solve_middle.Sandwich` of its four functions (default
    `SANDWICH`, `SANDWICH_PLAIN` for the plain path on a card).

    `pre_solve_fn(states, view: PreSolveView)` is the PreSolve analog,
    consulted on the whole batch between collide and solve and at every
    TOI sub-step (see PreSolveView). `filter_fn(states, fi, fj) -> bool` is the custom
    contact filter (b2ContactFilter::ShouldCollide override,
    b2WorldCallbacks.h:52-62): fi, fj are integer fixture-index tensors
    with a leading world axis, and False vetoes the pair on top of the
    built-in filters in every pair refresh. Pass the same function to
    `WorldBuilder.freeze(filter_fn=...)` so that the construction-time
    pair pass agrees. Neither hook adds a host sync of its own.

    The step and its phases are spans (`b2.step` and its children, see
    `box2d_mt_tpu_torch.trace`): ranges on the host's timeline under
    `torch.profiler`, and the units by which `trace.collect()` counts
    host reads."""
    if not 1 <= max_colors <= 32:
        raise ValueError(
            f"max_colors must be in [1, 32] (got {max_colors}): the "
            "large-world coloring tier tracks per-body colors as 32-bit masks")
    middle = middle or solve_middle
    toi = toi or time_of_impact_lanes
    sandwich = sandwich or SANDWICH
    if toi_capacity is None:
        toi_capacity = max(32, states.contacts.capacity // 8)
    dt = float(np.float32(dt))
    syncs = HostSyncs()
    with syncs.span("step"):
        new_state, events = _step_batched(
            states, dt, velocity_iterations, position_iterations, warm_starting,
            allow_sleep, max_colors, continuous, toi_rounds, kinds, toi_capacity,
            pre_solve_fn, filter_fn, toi_neighbors, middle, toi, sandwich, syncs)
    trace.merge(syncs)
    return new_state, events._replace(host_syncs=syncs.count)


def _step_batched(states: State, dt: float, velocity_iterations,
                  position_iterations, warm_starting, allow_sleep, max_colors,
                  continuous, toi_rounds, kinds, toi_capacity, pre_solve_fn,
                  filter_fn, toi_neighbors, middle, toi, sandwich,
                  syncs: HostSyncs) -> Tuple[State, Events]:
    """step_batched's body, inside its span; the Events' host_syncs is
    left to the caller."""
    nc = states.contacts.capacity
    nf = states.fixtures.capacity
    with syncs.span("pairs"):
        b0 = states.bodies
        world_active = (b0.awake & (b0.body_type >= 0)
                        & (b0.body_type != settings.STATIC_BODY)).any(1)
        # the table's contact kinds and sensor pairs, read with the first
        # predicates: the collide phase runs only the colliders of kinds
        # that have a pair, and the sensor test only when a sensor pair
        # exists
        kinds = tuple(k for k in kinds if k != nph.KIND_INVALID)
        kind, sensor = _pair_kinds(states)
        dirty, active, all_active, any_sensor, *present = syncs.flags(
            states.pairs_dirty.any(), world_active.any(), world_active.all(),
            *_table_flags(kind, sensor, states.contacts.f_a >= 0, kinds))
        if dirty:
            # between-step mutations: pairs are found at the START of Step
            # (e_newFixture -> FindNewContacts, b2World.cpp:1628-1639), in
            # the worlds a mutation marked
            f_a, f_b, _ = broadphase.find_pairs(states, nc, filter_fn, syncs)
            states = dataclasses.replace(states, contacts=where_worlds(
                states.pairs_dirty,
                broadphase.carry_over_contacts(states.contacts, f_a, f_b, nf),
                states.contacts))
            kind, sensor = _pair_kinds(states)
            any_sensor, *present = syncs.flags(
                *_table_flags(kind, sensor, states.contacts.f_a >= 0, kinds))
        table = _Table(tuple(k for k, p in zip(kinds, present) if p), kind, sensor,
                       any_sensor)
        states = dataclasses.replace(states,
                                     pairs_dirty=torch.zeros_like(states.pairs_dirty))
    if not active:
        # all-asleep fast path: the whole step is identity
        return states, _idle_events(states.contacts, 0)
    new_state, events, enabled = _step_active(
        states, dt, velocity_iterations, position_iterations, warm_starting,
        allow_sleep, max_colors, table, middle, sandwich, syncs, pre_solve_fn,
        filter_fn, None if all_active else ~world_active)
    if continuous and toi_rounds > 0:
        with syncs.span("toi"):
            if enabled is not None:
                # the contact's enabled flag, as the collide pass left it,
                # on the refreshed table; a pair the refresh created starts
                # enabled
                enabled = _carry_flags(events.f_a, events.f_b, enabled,
                                       new_state.contacts.f_a, new_state.contacts.f_b, nf)
            new_state, toi_overflow, toi_begin, toi_imp = _continuous(
                new_state, dt, velocity_iterations, toi_rounds, kinds,
                toi_capacity, toi_neighbors, toi, syncs, enabled, pre_solve_fn)
        # TOI touches index the refreshed pair table, so they go out on
        # their own slot basis (toi_begin with toi_f_a/toi_f_b)
        events = events._replace(toi_overflow=toi_overflow, toi_begin=toi_begin,
                                 toi_normal_impulse=toi_imp[..., 0:2],
                                 toi_tangent_impulse=toi_imp[..., 2:4])
    if not all_active:
        # a world with every body asleep steps as the all-asleep fast path
        # steps it, whatever its batch-mates do (identity, no events)
        new_state = where_worlds(world_active, new_state, states)
        idle = _idle_events(states.contacts, 0)
        events = Events(*(torch.where(world_active.reshape((-1,) + (1,) * (x.dim() - 1)),
                                      x, y)
                          for x, y in zip(events[:-1], idle[:-1])), host_syncs=0)
    return new_state, events


def _idle_events(c: Contacts, host_syncs: int) -> Events:
    """The Events of a step in which every body sleeps."""
    zc = torch.zeros_like(c.touching)
    zw = torch.zeros(c.f_a.shape[0], dtype=torch.int32, device=zc.device)
    return Events(
        begin_touch=zc, end_touch=zc, f_a=c.f_a, f_b=c.f_b,
        pair_overflow=zw, color_overflow=zw, toi_overflow=zw,
        normal_impulse=torch.zeros_like(c.normal_impulse),
        tangent_impulse=torch.zeros_like(c.tangent_impulse),
        touching=c.touching, toi_begin=zc, toi_f_a=c.f_a, toi_f_b=c.f_b,
        toi_normal_impulse=torch.zeros_like(c.normal_impulse),
        toi_tangent_impulse=torch.zeros_like(c.tangent_impulse),
        host_syncs=host_syncs)


def _carry_flags(old_f_a, old_f_b, flags, f_a, f_b, nf: int):
    """Per-pair flags (W, C) of one pair table moved onto another by
    canonical key; pairs new to the second table get True."""
    big = torch.iinfo(torch.int64).max

    def key(fa, fb):
        return torch.where(fa >= 0, torch.minimum(fa, fb).long() * nf
                           + torch.maximum(fa, fb).long(), big)

    skey, perm = torch.sort(key(old_f_a, old_f_b), dim=1)
    new_key = key(f_a, f_b)
    pos = torch.searchsorted(skey, new_key).clamp_max(skey.shape[1] - 1)
    hit = (torch.gather(skey, 1, pos) == new_key) & (new_key != big)
    return ~hit | torch.gather(flags, 1, torch.gather(perm, 1, pos))


def _continuous(states: State, dt: float, velocity_iterations, toi_rounds,
                kinds, toi_capacity, toi_neighbors, toi, syncs: HostSyncs,
                enabled=None, pre_solve_fn=None):
    """The TOI phase behind the body-motion pre-gate: a TOI event needs a
    pair moving more than half a linear slop relative to each other, which
    needs a body moving more than a quarter slop, so when no awake body did
    this step the phase is skipped (the batched analog of the per-contact
    skip in b2World.cpp:1534-1541). The alpha0 reset applies either way.
    `enabled` (W, C): the PreSolve hook's collide-time answer on this
    table, which gates TOI candidacy; `pre_solve_fn` is consulted again at
    each sub-step."""
    b = states.bodies
    _, b_rmax = _body_rmax(states.fixtures, b.capacity)
    lin = torch.sqrt(((b.c - b.c0) ** 2).sum(-1))
    moving = b.awake & (b.body_type >= 0) & (b.body_type != settings.STATIC_BODY)
    motion = torch.where(moving, lin + torch.abs(b.a - b.a0) * b_rmax, 0.0)
    moved = (motion > 0.25 * settings.LINEAR_SLOP).any(1)
    if syncs.flag(moved.any()):
        return _solve_toi_b(states, dt, velocity_iterations, toi_rounds, kinds,
                            toi_capacity, toi_neighbors, toi, syncs, enabled,
                            pre_solve_fn, moved)
    zw = torch.zeros(states.n_worlds, dtype=torch.int32, device=b.c.device)
    return (dataclasses.replace(states, bodies=dataclasses.replace(
        b, alpha0=torch.zeros_like(b.alpha0))), zw,
        torch.zeros_like(states.contacts.touching),
        torch.zeros(states.contacts.normal_impulse.shape[:2] + (4,), device=b.c.device))


def _same(*pairs) -> torch.Tensor:
    """(W,) bool: in each world, each tensor of the pairs (a, b, c, d, ...)
    equals its partner."""
    out = None
    for a, b in zip(pairs[0::2], pairs[1::2]):
        eq = (a == b).reshape(a.shape[0], -1).all(1)
        out = eq if out is None else out & eq
    return out


def _all_but(per_world: torch.Tensor, idle) -> torch.Tensor:
    """per_world (W,) holds in every world but the `idle` ones (None: all)."""
    return (per_world if idle is None else per_world | idle).all()


def _step_active(states: State, dt: float, velocity_iterations,
                 position_iterations, warm_starting, allow_sleep, max_colors,
                 table, middle, sandwich, syncs: HostSyncs, pre_solve_fn=None,
                 filter_fn=None, idle=None):
    """The phase pipeline with the cross-step graph-pass cache: island
    labels and colors depend only on the contact and joint graph, so they
    are reused while the signatures of every world match
    (world.py:2099-2185); `idle` (W,) marks the worlds whose bodies all
    sleep (None: none), whose signatures are not read. The PreSolve hook
    runs between collide and the touch pass (world.py:2066-2098). Returns
    (state, events, the hook's `enabled` (W, C) on this step's table, or
    None without a hook)."""
    with syncs.span("collide"):
        manifold, sensor_touch, ba, bb = _collide_b(states, table, syncs)
    enabled = None
    if pre_solve_fn is not None:
        with syncs.span("pre_solve_hook"):
            c = states.contacts
            touching_now = (c.f_a >= 0) & torch.where(table.sensor, sensor_touch,
                                                      manifold.count > 0)
            enabled, written = _hook_out(
                pre_solve_fn(states, _table_view(states, manifold, ba, bb, touching_now)),
                c.touching)
            if written:
                # the setters persist on the contact (b2Contact.h:126-157)
                states = dataclasses.replace(states,
                                             contacts=dataclasses.replace(c, **written))
            if enabled is None:
                enabled = torch.ones_like(c.touching)
    nb = states.bodies.capacity
    cache = states.cache
    with syncs.span("touch"):
        pt = _pre_touch(states, manifold, table.sensor, sensor_touch, ba, bb, enabled)
    f_a, f_b = states.contacts.f_a, states.contacts.f_b
    with syncs.span("islands"):
        jb_a, jb_b, j_active = build_joint_arrays(states.joints)
        valid_all = cache.valid.all()
        table_same = _same(f_a, cache.sig_f_a, f_b, cache.sig_f_b)
        label_sig = [pt.solvable, cache.sig_solv, pt.non_static, cache.sig_ns]
        if jb_a is not None:
            label_sig += [j_active, cache.sig_jact, jb_a, cache.sig_jba, jb_b,
                          cache.sig_jbb]
        # a world whose bodies all sleep keeps its state and cache whatever
        # its batch-mates do (step_batched), so its signature is not read
        labels_same = valid_all & _all_but(table_same & _same(*label_sig), idle)
        if syncs.flag(labels_same):
            labels = cache.labels
        elif jb_a is None:
            labels = islands.island_labels(nb, ba, bb, pt.solvable, pt.non_static,
                                           syncs=syncs)
        else:
            # joint edges join islands like touching contacts
            labels = islands.island_labels(
                nb, torch.cat([ba, jb_a.long()], 1), torch.cat([bb, jb_b.long()], 1),
                torch.cat([pt.solvable, j_active], 1), pt.non_static, syncs=syncs)
    with syncs.span("coloring"):
        awake, cc_active = _cc_active_of(pt, labels, ba, bb)
        colors_same = valid_all & _all_but(
            table_same & _same(cc_active, cache.sig_cc, pt.dyn_a, cache.sig_dyn_a,
                               pt.dyn_b, cache.sig_dyn_b), idle)
        if syncs.flag(colors_same):
            color, color_overflow, rank = (cache.color, cache.color_overflow,
                                           cache.rank)
        else:
            syncs.event("coloring.runs")
            color, color_overflow, rank = coloring.color_constraints(
                ba, bb, pt.dyn_a, pt.dyn_b, cc_active, nb, max_colors,
                with_rank=True, syncs=syncs)
    new_cache = dataclasses.replace(
        cache, valid=torch.ones_like(cache.valid), labels=labels.to(torch.int32),
        color=color, rank=rank, color_overflow=color_overflow,
        sig_solv=pt.solvable, sig_ns=pt.non_static, sig_f_a=f_a, sig_f_b=f_b,
        sig_cc=cc_active, sig_dyn_a=pt.dyn_a, sig_dyn_b=pt.dyn_b)
    if jb_a is not None:
        new_cache = dataclasses.replace(new_cache, sig_jact=j_active,
                                        sig_jba=jb_a, sig_jbb=jb_b)

    with syncs.span("prepare"):
        pre = _pre_finish(states, pt, labels, awake, cc_active, color,
                          color_overflow, dt, warm_starting, ba, bb)
    with syncs.span("solve"):
        if jb_a is None:
            mids = _solve_middle_b(states.bodies.c, states.bodies.a, pre, dt,
                                   velocity_iterations, position_iterations,
                                   max_colors, middle)
        else:
            mids = _solve_sandwich_b(states, pre, dt, velocity_iterations,
                                     position_iterations, warm_starting, max_colors,
                                     sandwich, syncs)
    with syncs.span("post_solve"):
        new_state, events = _post_solve_b(states, pre, dt, allow_sleep, mids, syncs,
                                          filter_fn)
    return dataclasses.replace(new_state, cache=new_cache), events, enabled


def step(state: State, dt, velocity_iterations: int = 8,
         position_iterations: int = 3, warm_starting: bool = True,
         allow_sleep: bool = True, max_colors: int = settings.MAX_COLORS,
         continuous: bool = True, toi_rounds: int = 8,
         kinds=nph.ALL_KINDS, toi_capacity=None,
         pre_solve_fn=None, filter_fn=None,
         toi_neighbors: bool = True) -> Tuple[State, Events]:
    """Single-world step: the state is a batch of one world."""
    if state.n_worlds != 1:
        raise ValueError(f"step takes one world, got {state.n_worlds}; "
                         "use step_batched")
    return step_batched(
        state, dt, velocity_iterations=velocity_iterations,
        position_iterations=position_iterations, warm_starting=warm_starting,
        allow_sleep=allow_sleep, max_colors=max_colors, continuous=continuous,
        toi_rounds=toi_rounds, kinds=kinds, toi_capacity=toi_capacity,
        pre_solve_fn=pre_solve_fn, filter_fn=filter_fn,
        toi_neighbors=toi_neighbors)


# --------------------------------------------------------------------------
# host-side builder
# --------------------------------------------------------------------------


def _next_pow2(n):
    return max(8, 1 << (int(n - 1)).bit_length()) if n > 0 else 8


@dataclasses.dataclass
class _BodyDef:
    body_type: int
    position: Tuple[float, float]
    angle: float
    linear_velocity: Tuple[float, float]
    angular_velocity: float
    linear_damping: float
    angular_damping: float
    allow_sleep: bool
    awake: bool
    fixed_rotation: bool
    bullet: bool
    enabled: bool
    gravity_scale: float


@dataclasses.dataclass
class _FixtureDef:
    body: int
    shape: object
    density: float
    friction: float
    restitution: float
    is_sensor: bool
    filter_category: int
    filter_mask: int
    filter_group: int
    thick_shape: bool


class WorldBuilder:
    """Host-side world construction; `freeze()` yields a one-world State.
    Bodies, circle/edge/polygon/chain fixtures (sensors included) and the
    eleven joint types."""

    def __init__(self, gravity=(0.0, -10.0)):
        self.gravity = tuple(gravity)
        self._bodies: list = []
        self._fixtures: list = []
        self._joints: dict = {}   # kind -> list of def dicts

    def create_body(self, body_type=settings.STATIC_BODY, position=(0.0, 0.0),
                    angle=0.0, linear_velocity=(0.0, 0.0), angular_velocity=0.0,
                    linear_damping=0.0, angular_damping=0.0, allow_sleep=True,
                    awake=True, fixed_rotation=False, bullet=False,
                    enabled=True, gravity_scale=1.0) -> int:
        self._bodies.append(_BodyDef(
            body_type, tuple(position), angle, tuple(linear_velocity),
            angular_velocity, linear_damping, angular_damping, allow_sleep,
            awake, fixed_rotation, bullet, enabled, gravity_scale))
        return len(self._bodies) - 1

    def create_fixture(self, body: int, shape, density=0.0, friction=0.2,
                       restitution=0.0, is_sensor=False, filter_category=1,
                       filter_mask=0xFFFF, filter_group=0,
                       thick_shape=False) -> int:
        """Returns the fixture index (the first child's for a chain, which
        becomes one edge fixture per child)."""
        if not isinstance(shape, (shapes.Circle, shapes.Edge, shapes.Polygon,
                                  shapes.Chain)):
            raise TypeError(f"unknown shape {type(shape).__name__}")
        first = len(self._fixtures)
        children = shape.children() if isinstance(shape, shapes.Chain) else [shape]
        for child in children:
            self._fixtures.append(_FixtureDef(
                body, child, density, friction, restitution, is_sensor,
                filter_category, filter_mask, filter_group, thick_shape))
        return first

    def _add_joint(self, kind: str, **kw) -> int:
        lst = self._joints.setdefault(kind, [])
        lst.append(kw)
        return len(lst) - 1

    def create_joint_raw(self, kind: str, **fields) -> int:
        """Append a joint from raw local-frame def fields (local anchors,
        axes, reference angles, ...), bypassing the world-anchor helpers."""
        if kind not in _BLOCK_NAMES:
            raise ValueError(f"unknown joint kind: {kind}")
        return self._add_joint(kind, **fields)

    def create_revolute_joint(self, body_a, body_b, anchor, *,
                              collide_connected=False, enable_limit=False,
                              lower_angle=0.0, upper_angle=0.0,
                              enable_motor=False, motor_speed=0.0,
                              max_motor_torque=0.0, reference_angle=None):
        """b2RevoluteJointDef::Initialize (world anchor)."""
        if reference_angle is None:
            reference_angle = self._bodies[body_b].angle - self._bodies[body_a].angle
        return self._add_joint(
            "revolute", body_a=body_a, body_b=body_b,
            local_anchor_a=self._to_local(body_a, anchor),
            local_anchor_b=self._to_local(body_b, anchor),
            reference_angle=reference_angle,
            collide_connected=collide_connected, enable_limit=enable_limit,
            lower_angle=lower_angle, upper_angle=upper_angle,
            enable_motor=enable_motor, motor_speed=motor_speed,
            max_motor_torque=max_motor_torque)

    def create_distance_joint(self, body_a, body_b, anchor_a, anchor_b, *,
                              collide_connected=False, frequency=0.0,
                              damping_ratio=0.0, length=None):
        if length is None:
            length = math.dist(anchor_a, anchor_b)
        return self._add_joint(
            "distance", body_a=body_a, body_b=body_b,
            local_anchor_a=self._to_local(body_a, anchor_a),
            local_anchor_b=self._to_local(body_b, anchor_b),
            length=max(length, settings.LINEAR_SLOP),
            frequency=frequency, damping_ratio=damping_ratio,
            collide_connected=collide_connected)

    def create_prismatic_joint(self, body_a, body_b, anchor, axis, *,
                               collide_connected=False, enable_limit=False,
                               lower_translation=0.0, upper_translation=0.0,
                               enable_motor=False, motor_speed=0.0,
                               max_motor_force=0.0, reference_angle=None):
        if reference_angle is None:
            reference_angle = self._bodies[body_b].angle - self._bodies[body_a].angle
        return self._add_joint(
            "prismatic", body_a=body_a, body_b=body_b,
            local_anchor_a=self._to_local(body_a, anchor),
            local_anchor_b=self._to_local(body_b, anchor),
            local_axis_a=self._to_local_vector(body_a, axis),
            reference_angle=reference_angle,
            collide_connected=collide_connected, enable_limit=enable_limit,
            lower_translation=lower_translation,
            upper_translation=upper_translation, enable_motor=enable_motor,
            motor_speed=motor_speed, max_motor_force=max_motor_force)

    def create_weld_joint(self, body_a, body_b, anchor, *,
                          collide_connected=False, frequency=0.0,
                          damping_ratio=0.0, reference_angle=None):
        if reference_angle is None:
            reference_angle = self._bodies[body_b].angle - self._bodies[body_a].angle
        return self._add_joint(
            "weld", body_a=body_a, body_b=body_b,
            local_anchor_a=self._to_local(body_a, anchor),
            local_anchor_b=self._to_local(body_b, anchor),
            reference_angle=reference_angle,
            frequency=frequency, damping_ratio=damping_ratio,
            collide_connected=collide_connected)

    def create_friction_joint(self, body_a, body_b, anchor, *,
                              collide_connected=False, max_force=0.0,
                              max_torque=0.0):
        return self._add_joint(
            "friction", body_a=body_a, body_b=body_b,
            local_anchor_a=self._to_local(body_a, anchor),
            local_anchor_b=self._to_local(body_b, anchor),
            max_force=max_force, max_torque=max_torque,
            collide_connected=collide_connected)

    def create_rope_joint(self, body_a, body_b, local_anchor_a,
                          local_anchor_b, max_length, *,
                          collide_connected=False):
        return self._add_joint(
            "rope", body_a=body_a, body_b=body_b,
            local_anchor_a=tuple(local_anchor_a),
            local_anchor_b=tuple(local_anchor_b), max_length=max_length,
            collide_connected=collide_connected)

    def create_motor_joint(self, body_a, body_b, *, collide_connected=False,
                           max_force=1.0, max_torque=1.0,
                           correction_factor=0.3, linear_offset=None,
                           angular_offset=None):
        """b2MotorJointDef::Initialize defaults: the current relative
        transform."""
        if linear_offset is None:
            linear_offset = self._to_local(body_a, self._bodies[body_b].position)
        if angular_offset is None:
            angular_offset = self._bodies[body_b].angle - self._bodies[body_a].angle
        return self._add_joint(
            "motor", body_a=body_a, body_b=body_b,
            linear_offset=tuple(linear_offset), angular_offset=angular_offset,
            max_force=max_force, max_torque=max_torque,
            correction_factor=correction_factor,
            collide_connected=collide_connected)

    def create_mouse_joint(self, body_b, target, *, max_force=0.0,
                           frequency=5.0, damping_ratio=0.7):
        """b2MouseJoint: soft drag of body_b toward a world target."""
        return self._add_joint(
            "mouse", body_a=body_b, body_b=body_b, target=tuple(target),
            local_anchor_b=self._to_local(body_b, target), max_force=max_force,
            frequency=frequency, damping_ratio=damping_ratio,
            collide_connected=True)

    def create_wheel_joint(self, body_a, body_b, anchor, axis, *,
                           collide_connected=False, enable_motor=False,
                           motor_speed=0.0, max_motor_torque=0.0,
                           frequency=2.0, damping_ratio=0.7):
        return self._add_joint(
            "wheel", body_a=body_a, body_b=body_b,
            local_anchor_a=self._to_local(body_a, anchor),
            local_anchor_b=self._to_local(body_b, anchor),
            local_axis_a=self._to_local_vector(body_a, axis),
            enable_motor=enable_motor, motor_speed=motor_speed,
            max_motor_torque=max_motor_torque, frequency=frequency,
            damping_ratio=damping_ratio, collide_connected=collide_connected)

    def create_pulley_joint(self, body_a, body_b, ground_anchor_a,
                            ground_anchor_b, anchor_a, anchor_b, ratio=1.0, *,
                            collide_connected=True):
        length_a = math.dist(anchor_a, ground_anchor_a)
        length_b = math.dist(anchor_b, ground_anchor_b)
        return self._add_joint(
            "pulley", body_a=body_a, body_b=body_b,
            ground_anchor_a=tuple(ground_anchor_a),
            ground_anchor_b=tuple(ground_anchor_b),
            local_anchor_a=self._to_local(body_a, anchor_a),
            local_anchor_b=self._to_local(body_b, anchor_b),
            length_a=length_a, length_b=length_b, ratio=ratio,
            constant=length_a + ratio * length_b,
            collide_connected=collide_connected)

    def create_gear_joint(self, joint1, joint2, ratio=1.0, *,
                          collide_connected=False):
        """b2GearJoint (b2GearJoint.cpp:45-130): couples two revolute or
        prismatic joints, each given as ("revolute" | "prismatic", index),
        so that coordinate1 + ratio * coordinate2 keeps its build-time
        value. Body roles as in the reference constructor: A = joint1.bodyB,
        C = joint1.bodyA, B = joint2.bodyB, D = joint2.bodyA."""
        (kind1, i1), (kind2, i2) = joint1, joint2
        for kind in (kind1, kind2):
            if kind not in ("revolute", "prismatic"):
                raise ValueError(f"a gear couples revolute or prismatic joints, not {kind}")
        j1, j2 = self._joints[kind1][i1], self._joints[kind2][i2]
        coord_a, geo1 = self._gear_coordinate(kind1, j1)
        coord_b, geo2 = self._gear_coordinate(kind2, j2)
        return self._add_joint(
            "gear", body_a=j1["body_b"], body_b=j2["body_b"],
            body_c=j1["body_a"], body_d=j2["body_a"],
            joint1_type=0 if kind1 == "revolute" else 1, joint1_index=i1,
            joint2_type=0 if kind2 == "revolute" else 1, joint2_index=i2,
            local_anchor_a=geo1["anchor_b"], local_anchor_c=geo1["anchor_a"],
            local_anchor_b=geo2["anchor_b"], local_anchor_d=geo2["anchor_a"],
            local_axis_c=geo1["axis"], local_axis_d=geo2["axis"],
            reference_angle_a=geo1["ref"], reference_angle_b=geo2["ref"],
            ratio=ratio, constant=coord_a + ratio * coord_b,
            collide_connected=collide_connected)

    def _gear_coordinate(self, kind, j):
        """A coupled joint's gear coordinate at build time, from the
        bodies' build-time transforms as the reference constructor reads
        them (b2GearJoint.cpp:70-91, :102-123), and the geometry the gear
        copies."""
        bda, bdb = self._bodies[j["body_a"]], self._bodies[j["body_b"]]
        geo = dict(anchor_a=j["local_anchor_a"], anchor_b=j["local_anchor_b"],
                   ref=j["reference_angle"])
        if kind == "revolute":
            geo["axis"] = (0.0, 0.0)
            return bdb.angle - bda.angle - j["reference_angle"], geo
        geo["axis"] = j["local_axis_a"]
        # pA in C's frame: MulT(xfC.q, Mul(xfA.q, anchorB) + (xfA.p - xfC.p))
        s_c, c_c = math.sin(bda.angle), math.cos(bda.angle)
        s_a, c_a = math.sin(bdb.angle), math.cos(bdb.angle)
        lax_, lay_ = j["local_anchor_b"]
        wx = c_a * lax_ - s_a * lay_ + bdb.position[0] - bda.position[0]
        wy = s_a * lax_ + c_a * lay_ + bdb.position[1] - bda.position[1]
        px = c_c * wx + s_c * wy
        py = -s_c * wx + c_c * wy
        ax_, ay_ = j["local_axis_a"]
        coord = ((px - j["local_anchor_a"][0]) * ax_
                 + (py - j["local_anchor_a"][1]) * ay_)
        return coord, geo

    def _to_local(self, body: int, world_point):
        b = self._bodies[body]
        s, c = math.sin(b.angle), math.cos(b.angle)
        dx = world_point[0] - b.position[0]
        dy = world_point[1] - b.position[1]
        return (c * dx + s * dy, -s * dx + c * dy)

    def _to_local_vector(self, body: int, world_vec):
        b = self._bodies[body]
        s, c = math.sin(b.angle), math.cos(b.angle)
        return (c * world_vec[0] + s * world_vec[1],
                -s * world_vec[0] + c * world_vec[1])

    def freeze(self, body_capacity: Optional[int] = None,
               fixture_capacity: Optional[int] = None,
               contact_capacity: Optional[int] = None,
               joint_capacity: Optional[dict] = None,
               filter_fn=None, device="cuda") -> State:
        """Pack into a one-world State on `device` (the card unless the
        caller asks for another), with the initial fat AABBs and pair
        table. Capacities default as in the JAX package; `joint_capacity`
        maps a joint kind to the slots to preallocate; `filter_fn` is the
        contact-filter hook of `step_batched`, for the construction-time
        pair pass."""
        nb = body_capacity or _next_pow2(len(self._bodies))
        nf = fixture_capacity or _next_pow2(len(self._fixtures))
        nc = contact_capacity or _next_pow2(max(64, 4 * len(self._fixtures)))
        if nb < len(self._bodies) or nf < len(self._fixtures):
            raise ValueError("capacity below the number of bodies or fixtures")

        def t(x):
            return torch.from_numpy(np.array(x)[None]).to(device)

        bodies = Bodies(**{k: t(v) for k, v in
                           _pack_bodies(self._bodies, self._fixtures, nb).items()})
        fixtures = Fixtures(**{k: t(v) for k, v in
                               _pack_fixtures(self._fixtures, nf).items()})
        contacts = Contacts(**{k: t(v) for k, v in _empty_contacts(nc).items()})
        joints = build_joints(self._joints, joint_capacity, device)
        state = State(
            bodies=bodies, fixtures=fixtures, contacts=contacts, joints=joints,
            gravity=t(np.asarray(self.gravity, np.float32)),
            inv_dt0=t(np.float32(0.0)), pairs_dirty=t(False),
            cache=make_empty_cache(nb, nc, joints.count, 1, device))
        return _init_broadphase(state, filter_fn)


def _init_broadphase(state: State, filter_fn=None) -> State:
    """Initial fat AABBs + pair table (the construction-time
    FindNewContacts pass, b2World.cpp:1628-1639)."""
    p, q = body_xf(state.bodies.c, state.bodies.a, state.bodies.local_center)
    fb = state.fixtures.body.clamp_min(0).long()
    lo, hi = broadphase.initial_fat_aabbs(state.fixtures, take(p, fb), take(q, fb))
    state = dataclasses.replace(state, fixtures=dataclasses.replace(
        state.fixtures, aabb_lo=lo, aabb_hi=hi))
    f_a, f_b, _ = broadphase.find_pairs(state, state.contacts.capacity, filter_fn)
    return dataclasses.replace(state, contacts=broadphase.carry_over_contacts(
        state.contacts, f_a, f_b, state.fixtures.capacity))


def _pack_bodies(defs, fixture_defs, nb) -> dict:
    z = lambda *s: np.zeros(s, np.float32)
    body_type = np.full(nb, -1, np.int32)
    c = z(nb, 2); a = z(nb); local_center = z(nb, 2)
    v = z(nb, 2); w = z(nb)
    inv_mass = z(nb); inv_inertia = z(nb)
    lin_damp = z(nb); ang_damp = z(nb); grav = z(nb)
    awake = np.zeros(nb, bool); allow_sleep = np.zeros(nb, bool)
    fixed_rot = np.zeros(nb, bool); bullet = np.zeros(nb, bool)
    enabled = np.zeros(nb, bool)

    # per-body mass data from fixtures (b2Body::ResetMassData)
    for i, bd in enumerate(defs):
        body_type[i] = bd.body_type
        lin_damp[i] = bd.linear_damping
        ang_damp[i] = bd.angular_damping
        grav[i] = bd.gravity_scale
        awake[i] = bd.awake
        allow_sleep[i] = bd.allow_sleep
        fixed_rot[i] = bd.fixed_rotation
        bullet[i] = bd.bullet
        enabled[i] = bd.enabled
        a[i] = bd.angle

        mass = 0.0
        center = np.zeros(2)
        inertia = 0.0
        if bd.body_type == settings.DYNAMIC_BODY:
            for fd in fixture_defs:
                if fd.body != i or fd.density == 0.0:
                    continue
                md = fd.shape.compute_mass(fd.density)
                mass += md.mass
                center += md.mass * np.asarray(md.center)
                inertia += md.inertia
            if mass > 0.0:
                center /= mass
                inertia -= mass * float(center @ center)
            else:
                mass = 1.0
                inertia = 0.0
            if bd.fixed_rotation:
                inertia = 0.0
            inv_mass[i] = 1.0 / mass
            inv_inertia[i] = 1.0 / inertia if inertia > 0.0 else 0.0

        local_center[i] = center
        s_, c_ = math.sin(bd.angle), math.cos(bd.angle)
        world_center = (bd.position[0] + c_ * center[0] - s_ * center[1],
                        bd.position[1] + s_ * center[0] + c_ * center[1])
        c[i] = world_center
        # velocity given at origin; shift to center of mass
        v[i] = (bd.linear_velocity[0] - bd.angular_velocity * (world_center[1] - bd.position[1]),
                bd.linear_velocity[1] + bd.angular_velocity * (world_center[0] - bd.position[0]))
        w[i] = bd.angular_velocity

    return dict(
        body_type=body_type, c=c, a=a, c0=c.copy(), a0=a.copy(),
        alpha0=z(nb), local_center=local_center, v=v, w=w,
        force=z(nb, 2), torque=z(nb), inv_mass=inv_mass,
        inv_inertia=inv_inertia, linear_damping=lin_damp,
        angular_damping=ang_damp, gravity_scale=grav, awake=awake,
        allow_sleep=allow_sleep, fixed_rotation=fixed_rot, bullet=bullet,
        enabled=enabled, sleep_time=z(nb))


def _pack_fixtures(defs, nf) -> dict:
    body = np.full(nf, -1, np.int32)
    shape_type = np.zeros(nf, np.int32)
    radius = np.zeros(nf, np.float32)
    verts = np.zeros((nf, 8, 2), np.float32)
    normals = np.zeros((nf, 8, 2), np.float32)
    nverts = np.zeros(nf, np.int32)
    ghosts = np.zeros((nf, 2), bool)
    friction = np.zeros(nf, np.float32)
    restitution = np.zeros(nf, np.float32)
    density = np.zeros(nf, np.float32)
    is_sensor = np.zeros(nf, bool)
    cat = np.ones(nf, np.int32)
    mask = np.full(nf, 0xFFFF, np.int32)
    group = np.zeros(nf, np.int32)
    thick = np.zeros(nf, bool)

    for i, fd in enumerate(defs):
        body[i] = fd.body
        friction[i] = fd.friction
        restitution[i] = fd.restitution
        density[i] = fd.density
        is_sensor[i] = fd.is_sensor
        cat[i] = fd.filter_category
        mask[i] = fd.filter_mask
        group[i] = fd.filter_group
        thick[i] = fd.thick_shape
        s = fd.shape
        radius[i] = s.radius
        if isinstance(s, shapes.Circle):
            shape_type[i] = settings.SHAPE_CIRCLE
            verts[i, 0] = s.center
            nverts[i] = 1
        elif isinstance(s, shapes.Edge):
            shape_type[i] = settings.SHAPE_EDGE
            verts[i, 0] = s.v1
            verts[i, 1] = s.v2
            if s.v0 is not None:
                verts[i, 2] = s.v0
                ghosts[i, 0] = True
            if s.v3 is not None:
                verts[i, 3] = s.v3
                ghosts[i, 1] = True
            nverts[i] = 2
        else:
            shape_type[i] = settings.SHAPE_POLYGON
            m = len(s.vertices)
            verts[i, :m] = s.vertices
            normals[i, :m] = s.normals
            nverts[i] = m

    return dict(
        body=body, shape_type=shape_type, radius=radius, verts=verts,
        normals=normals, nverts=nverts, ghosts=ghosts, friction=friction,
        restitution=restitution, density=density, is_sensor=is_sensor,
        filter_category=cat, filter_mask=mask, filter_group=group,
        thick_shape=thick, aabb_lo=np.zeros((nf, 2), np.float32),
        aabb_hi=np.zeros((nf, 2), np.float32))


def _empty_contacts(nc) -> dict:
    return dict(
        f_a=np.full(nc, -1, np.int32), f_b=np.full(nc, -1, np.int32),
        m_type=np.zeros(nc, np.int32),
        m_local_point=np.zeros((nc, 2), np.float32),
        m_local_normal=np.zeros((nc, 2), np.float32),
        m_points=np.zeros((nc, 2, 2), np.float32),
        m_ids=np.zeros((nc, 2), np.int32), m_count=np.zeros(nc, np.int32),
        normal_impulse=np.zeros((nc, 2), np.float32),
        tangent_impulse=np.zeros((nc, 2), np.float32),
        touching=np.zeros(nc, bool), toi_count=np.zeros(nc, np.int32),
        tangent_speed=np.zeros(nc, np.float32),
        friction_override=np.full(nc, -1.0, np.float32),
        restitution_override=np.full(nc, -1.0, np.float32))
