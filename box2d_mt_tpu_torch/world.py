"""World construction and the batched step, contact-only slice.

Port of `box2d_mt_tpu.world`: `WorldBuilder` (b2World::CreateBody,
b2Body::CreateFixture) packs host shapes into a batched `State` of
tensors, and `step_batched` is b2World::Step (b2World.cpp:1613-1710) over
a batch of worlds, in the JAX package's phase order:

  1. Collide: manifolds for the persistent pair table, warm-start id
     matching, touch transitions wake bodies (`_collide_b`, `_pre_touch`).
  2. Solve: island labels + awake propagation and the constraint coloring,
     both cached across steps on graph signatures; velocity integration,
     constraint init, warm start (`_pre_finish`); the solve middle (CUDA
     kernel on a card); sleep (`_post_sleep_sync`).
  3. Synchronize fat AABBs, refresh the pair table and carry warm-start
     state over (`_post_solve_b`).

Each `lax.cond` / `lax.while_loop` predicate of the JAX program is read
back to the host here; `Events.host_syncs` counts those reads per step.

Not ported yet, and refused rather than skipped: continuous collision
(`continuous=True`), joints, sensors, the circle colliders, the
pre-solve/filter hooks, and the grid pair finder (above 1024 fixtures).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import settings, shapes
from .math2d import body_xf, take
from .ops import broadphase, coloring, integrate, islands
from .ops import narrowphase as nph
from .ops import solver as csolver
from .ops.solve_middle import solve_middle
from .ops.sync import HostSyncs
from .state import (Bodies, Contacts, Fixtures, Joints, SolverCache, State,
                    make_empty_cache)


class Events(NamedTuple):
    """Per-step outputs replacing b2ContactListener callbacks; the fields
    of the JAX package's Events plus the step's host-sync count."""
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
    toi_begin: torch.Tensor      # (W,C) bool (no TOI phase yet: all False)
    toi_f_a: torch.Tensor        # (W,C) i32 refreshed pair fixtures
    toi_f_b: torch.Tensor
    host_syncs: int              # device-to-host predicate reads this step


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
    begin_touch: torch.Tensor
    end_touch: torch.Tensor


class _Mids(NamedTuple):
    ni_it: torch.Tensor
    ti_it: torch.Tensor
    c: torch.Tensor
    a: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor
    min_sep: torch.Tensor


# --------------------------------------------------------------------------
# step phases
# --------------------------------------------------------------------------


def _collide_b(states: State, kinds):
    """Batched narrow phase (b2ContactManager::Collide). Every ported kind
    runs over all contact lanes and each lane keeps its own kind's result.
    Returns (manifold (W,C,...), ba, bb, unsupported): `unsupported` is a
    device flag set when an existing pair is a sensor pair or of a kind in
    `kinds` that is not ported."""
    fx, contacts, bodies = states.fixtures, states.contacts, states.bodies
    nw, nc = contacts.f_a.shape
    ia = contacts.f_a.clamp_min(0).long()
    ib = contacts.f_b.clamp_min(0).long()
    pair_exists = contacts.f_a >= 0
    ba = take(fx.body, ia).clamp_min(0).long()
    bb = take(fx.body, ib).clamp_min(0).long()
    kind = nph.contact_kind(take(fx.shape_type, ia), take(fx.shape_type, ib))
    sensor = take(fx.is_sensor, ia) | take(fx.is_sensor, ib)
    unported = torch.zeros_like(pair_exists)
    for k in kinds:
        if k not in nph.CORE_COLLIDERS:
            unported |= kind == k
    unsupported = (pair_exists & (sensor | unported)).any()

    p_all, q_all = body_xf(bodies.c, bodies.a, bodies.local_center)
    flat = lambda x: x.reshape((nw * nc,) + x.shape[2:])

    def lanes(idx, b):
        shape = nph.lanes_from_rows(
            flat(take(fx.verts, idx)), flat(take(fx.normals, idx)),
            flat(take(fx.nverts, idx)), flat(take(fx.ghosts, idx)),
            flat(take(fx.radius, idx)))
        p, q = flat(take(p_all, b)), flat(take(q_all, b))
        return shape, p[:, 0], p[:, 1], q[:, 0], q[:, 1]

    la, lb = lanes(ia, ba), lanes(ib, bb)
    dev = ia.device
    zi = torch.zeros((nw, nc), dtype=torch.int32, device=dev)
    man = nph.Manifold(
        mtype=zi, local_point=torch.zeros((nw, nc, 2), device=dev),
        local_normal=torch.zeros((nw, nc, 2), device=dev),
        points=torch.zeros((nw, nc, 2, 2), device=dev),
        ids=torch.zeros((nw, nc, 2), dtype=torch.int32, device=dev), count=zi)
    for k in kinds:
        if k not in nph.CORE_COLLIDERS:
            continue
        mk = nph.lanes_to_manifold(nph.CORE_COLLIDERS[k](*la, *lb))
        sel = (kind == k) & pair_exists
        man = nph.Manifold(*(
            torch.where(sel.reshape(sel.shape + (1,) * (old.dim() - 2)),
                        new.reshape(old.shape), old)
            for new, old in zip(mk, man)))
    return man, ba, bb, unsupported


def _pre_touch(state: State, manifold: nph.Manifold, ba, bb) -> _PreTouch:
    """Touch transitions + warm-start id matching + wake hits (the
    b2Contact::Update tail)."""
    bodies, contacts = state.bodies, state.contacts
    nw, nb = bodies.body_type.shape
    pair_exists = contacts.f_a >= 0
    touching = pair_exists & (manifold.count > 0)

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

    # touch transitions wake both bodies
    changed = pair_exists & (touching != contacts.touching)
    hit = torch.zeros((nw, nb + 1), dtype=torch.bool, device=ba.device)
    dump = torch.full_like(ba, nb)
    hit.scatter_(1, torch.cat([torch.where(changed, ba, dump),
                               torch.where(changed, bb, dump)], 1), True)
    awake0 = bodies.awake | hit[:, :nb]
    contacts = dataclasses.replace(
        contacts, m_type=manifold.mtype, m_local_point=manifold.local_point,
        m_local_normal=manifold.local_normal, m_points=manifold.points,
        m_ids=manifold.ids, m_count=manifold.count,
        normal_impulse=matched(contacts.normal_impulse),
        tangent_impulse=matched(contacts.tangent_impulse), touching=touching)

    non_static = bodies.exists & ~bodies.is_static & bodies.enabled
    dyn = bodies.is_dynamic & bodies.enabled
    return _PreTouch(
        contacts=contacts, awake0=awake0, non_static=non_static,
        solvable=touching, dyn_a=take(dyn, ba),
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
        cc_active=cc_active, begin_touch=pt.begin_touch,
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


def _solve_middle_b(c, a, pre: _PreSolve, dt: float, velocity_iterations,
                    position_iterations, max_colors, middle) -> _Mids:
    """Contact velocity/position iterations over the batch via the solve
    middle; impulses of lanes not solved this step keep their values."""
    args = middle_inputs(pre, c, a, max_colors)
    vel, pos, aux = middle(*args, dt, velocity_iterations, position_iterations)
    solved = pre.cc.active & (pre.color >= 0)
    ni_it = torch.where(solved[..., None], aux[:, 0:2].transpose(1, 2), pre.ni_it)
    ti_it = torch.where(solved[..., None], aux[:, 2:4].transpose(1, 2), pre.ti_it)
    min_sep = torch.where(solved, aux[:, 4], 0.0)
    return _Mids(ni_it=ni_it, ti_it=ti_it,
                 c=pos[:, 0:2].transpose(1, 2).contiguous(), a=pos[:, 2],
                 v=vel[:, 0:2].transpose(1, 2).contiguous(), w=vel[:, 2],
                 min_sep=min_sep)


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
    state_mid = dataclasses.replace(state, bodies=bodies, fixtures=fx,
                                    contacts=contacts, inv_dt0=inv_dt0)
    return state_mid, moved


def _post_solve_b(states: State, pre: _PreSolve, dt: float, allow_sleep,
                  mids: _Mids, syncs: HostSyncs) -> Tuple[State, Events]:
    """Sleep/sync, then the globally gated pair-table refresh: when no
    fixture in any world escaped its fat AABB the overlap set is unchanged
    and the broad phase is skipped (b2BroadPhase.h:211-267)."""
    nf = states.fixtures.capacity
    nc = states.contacts.capacity
    nw = states.n_worlds
    state_mid, moved = _post_sleep_sync(states, pre, dt, allow_sleep, mids)
    sm_c = state_mid.contacts
    zw = torch.zeros(nw, dtype=torch.int32, device=moved.device)
    contacts = dataclasses.replace(sm_c, toi_count=torch.zeros_like(sm_c.toi_count))
    pair_overflow = zw
    if syncs.flag(moved.any() | states.pairs_dirty.any()):
        f_a, f_b, pair_overflow = broadphase.find_pairs(state_mid, nc)
        # identity gate: an unchanged pair list keeps the table as it is
        if not syncs.flag((f_a == sm_c.f_a).all() & (f_b == sm_c.f_b).all()):
            contacts = broadphase.carry_over_contacts(sm_c, f_a, f_b, nf)
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
        toi_f_a=contacts.f_a, toi_f_b=contacts.f_b, host_syncs=0)
    return new_state, events


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
                 middle=None) -> Tuple[State, Events]:
    """One world-step over a batch of worlds (leading axis on every State
    leaf), with the JAX package's signature and semantics.

    `continuous=True` (the default, with toi_rounds > 0) needs the TOI
    phase, which is not ported yet: it raises NotImplementedError instead
    of skipping the phase; pass continuous=False. `toi_capacity` and
    `toi_neighbors` only shape that phase. `middle` is the solve-middle
    implementation (default `ops.solve_middle.solve_middle`: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors);
    `solve_middle_plain` runs the plain path on a card for comparison."""
    del toi_capacity, toi_neighbors
    if continuous and toi_rounds > 0:
        raise NotImplementedError(
            "continuous=True needs the TOI phase (_solve_toi_b with the "
            "time-of-impact kernel), which is not ported yet; pass "
            "continuous=False")
    if pre_solve_fn is not None or filter_fn is not None:
        raise NotImplementedError("the pre-solve and contact-filter hooks "
                                  "are not ported yet")
    if not 1 <= max_colors <= 32:
        raise ValueError(
            f"max_colors must be in [1, 32] (got {max_colors}): the "
            "large-world coloring tier tracks per-body colors as 32-bit masks")
    middle = middle or solve_middle
    dt = float(np.float32(dt))
    syncs = HostSyncs()
    nc = states.contacts.capacity
    nf = states.fixtures.capacity
    b0 = states.bodies
    any_active = (b0.awake & (b0.body_type >= 0)
                  & (b0.body_type != settings.STATIC_BODY)).any()
    dirty, active = syncs.flags(states.pairs_dirty.any(), any_active)
    if dirty:
        # between-step mutations: pairs are found at the START of Step
        # (e_newFixture -> FindNewContacts, b2World.cpp:1628-1639)
        f_a, f_b, _ = broadphase.find_pairs(states, nc)
        states = dataclasses.replace(states, contacts=broadphase.carry_over_contacts(
            states.contacts, f_a, f_b, nf))
    states = dataclasses.replace(states,
                                 pairs_dirty=torch.zeros_like(states.pairs_dirty))
    if not active:
        # all-asleep fast path: the whole step is identity
        c = states.contacts
        zc = torch.zeros_like(c.touching)
        zw = torch.zeros(states.n_worlds, dtype=torch.int32, device=zc.device)
        return states, Events(
            begin_touch=zc, end_touch=zc, f_a=c.f_a, f_b=c.f_b,
            pair_overflow=zw, color_overflow=zw, toi_overflow=zw,
            normal_impulse=torch.zeros_like(c.normal_impulse),
            tangent_impulse=torch.zeros_like(c.tangent_impulse),
            touching=c.touching, toi_begin=zc, toi_f_a=c.f_a, toi_f_b=c.f_b,
            host_syncs=syncs.count)
    new_state, events = _step_active(
        states, dt, velocity_iterations, position_iterations, warm_starting,
        allow_sleep, max_colors, kinds, middle, syncs)
    return new_state, events._replace(host_syncs=syncs.count)


def _step_active(states: State, dt: float, velocity_iterations,
                 position_iterations, warm_starting, allow_sleep, max_colors,
                 kinds, middle, syncs: HostSyncs):
    """The phase pipeline with the cross-step graph-pass cache: island
    labels and colors depend only on the contact graph, so they are reused
    while the batch-global signatures match (world.py:2099-2185)."""
    manifold, ba, bb, unsupported = _collide_b(states, kinds)
    nb = states.bodies.capacity
    cache = states.cache
    pt = _pre_touch(states, manifold, ba, bb)
    f_a, f_b = states.contacts.f_a, states.contacts.f_b
    valid_all = cache.valid.all()
    table_same = (f_a == cache.sig_f_a).all() & (f_b == cache.sig_f_b).all()
    labels_same = (valid_all & table_same
                   & (pt.solvable == cache.sig_solv).all()
                   & (pt.non_static == cache.sig_ns).all())
    bad, labels_same = syncs.flags(unsupported, labels_same)
    if bad:
        raise NotImplementedError(
            "the batch has a sensor pair or a contact of a kind whose "
            "collider is not ported yet (ported: polygon-polygon, "
            "edge-polygon)")
    if labels_same:
        labels = cache.labels
    else:
        labels = islands.island_labels(nb, ba, bb, pt.solvable, pt.non_static,
                                       syncs=syncs)
    awake, cc_active = _cc_active_of(pt, labels, ba, bb)
    colors_same = (valid_all & table_same & (cc_active == cache.sig_cc).all()
                   & (pt.dyn_a == cache.sig_dyn_a).all()
                   & (pt.dyn_b == cache.sig_dyn_b).all())
    if syncs.flag(colors_same):
        color, color_overflow, rank = (cache.color, cache.color_overflow,
                                       cache.rank)
    else:
        color, color_overflow, rank = coloring.color_constraints(
            ba, bb, pt.dyn_a, pt.dyn_b, cc_active, nb, max_colors,
            with_rank=True, syncs=syncs)
    new_cache = dataclasses.replace(
        cache, valid=torch.ones_like(cache.valid), labels=labels.to(torch.int32),
        color=color, rank=rank, color_overflow=color_overflow,
        sig_solv=pt.solvable, sig_ns=pt.non_static, sig_f_a=f_a, sig_f_b=f_b,
        sig_cc=cc_active, sig_dyn_a=pt.dyn_a, sig_dyn_b=pt.dyn_b)

    pre = _pre_finish(states, pt, labels, awake, cc_active, color,
                      color_overflow, dt, warm_starting, ba, bb)
    mids = _solve_middle_b(states.bodies.c, states.bodies.a, pre, dt,
                           velocity_iterations, position_iterations,
                           max_colors, middle)
    new_state, events = _post_solve_b(states, pre, dt, allow_sleep, mids, syncs)
    return dataclasses.replace(new_state, cache=new_cache), events


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
    Bodies and polygon/edge fixtures only: joints are not ported yet."""

    def __init__(self, gravity=(0.0, -10.0)):
        self.gravity = tuple(gravity)
        self._bodies: list = []
        self._fixtures: list = []

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
        """Returns the fixture index."""
        if not isinstance(shape, (shapes.Polygon, shapes.Edge)):
            raise NotImplementedError(
                f"{type(shape).__name__} shapes are not ported yet "
                "(polygons and edges are)")
        self._fixtures.append(_FixtureDef(
            body, shape, density, friction, restitution, is_sensor,
            filter_category, filter_mask, filter_group, thick_shape))
        return len(self._fixtures) - 1

    def __getattr__(self, name):
        # the JAX package's WorldBuilder joint methods (create_*_joint,
        # create_joint_raw)
        if name.startswith("create_") and "joint" in name:
            def refuse(*args, **kwargs):
                raise NotImplementedError(f"{name}: joints are not ported yet")
            return refuse
        raise AttributeError(name)

    def freeze(self, body_capacity: Optional[int] = None,
               fixture_capacity: Optional[int] = None,
               contact_capacity: Optional[int] = None,
               joint_capacity: Optional[dict] = None,
               filter_fn=None, device="cpu") -> State:
        """Pack into a one-world State on `device`, with the initial fat
        AABBs and pair table. Capacities default as in the JAX package."""
        if joint_capacity:
            raise NotImplementedError("joints are not ported yet")
        if filter_fn is not None:
            raise NotImplementedError("the contact-filter hook is not ported yet")
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
        state = State(
            bodies=bodies, fixtures=fixtures, contacts=contacts, joints=Joints(),
            gravity=t(np.asarray(self.gravity, np.float32)),
            inv_dt0=t(np.float32(0.0)), pairs_dirty=t(False),
            cache=make_empty_cache(nb, nc, 0, 1, device))
        return _init_broadphase(state)


def _init_broadphase(state: State) -> State:
    """Initial fat AABBs + pair table (the construction-time
    FindNewContacts pass, b2World.cpp:1628-1639)."""
    p, q = body_xf(state.bodies.c, state.bodies.a, state.bodies.local_center)
    fb = state.fixtures.body.clamp_min(0).long()
    lo, hi = broadphase.initial_fat_aabbs(state.fixtures, take(p, fb), take(q, fb))
    state = dataclasses.replace(state, fixtures=dataclasses.replace(
        state.fixtures, aabb_lo=lo, aabb_hi=hi))
    f_a, f_b, _ = broadphase.find_pairs(state, state.contacts.capacity)
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
        if isinstance(s, shapes.Edge):
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
