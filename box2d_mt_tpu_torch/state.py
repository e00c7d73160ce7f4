"""World state schema: fixed-capacity structure-of-arrays of tensors.

Mirrors `box2d_mt_tpu.state` field for field and capacity for capacity, so
a state built by either package can be compared leaf by leaf. Every leaf
carries a leading world axis W: the port batches worlds explicitly instead
of through `vmap`, and a single world is a batch of one.

Slot conventions (as in the JAX package):
  * empty body slots have `body_type == -1`
  * empty fixture slots have `body == -1`
  * empty contact slots have `f_a == -1`

Joints are typed blocks, one per joint class, as in the JAX package: all
eleven of its types, in its block order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _frozen(cls):
    return dataclasses.dataclass(frozen=True)(cls)


@_frozen
class Bodies:
    """SoA equivalent of b2Body (reference: b2Body.h:443-512); leaves (W, N...)."""

    body_type: torch.Tensor      # (W,N) i32: -1 empty / 0 static / 1 kinematic / 2 dynamic
    c: torch.Tensor              # (W,N,2) f32 world center of mass
    a: torch.Tensor              # (W,N) f32 angle
    c0: torch.Tensor             # (W,N,2) f32 sweep start center
    a0: torch.Tensor             # (W,N) f32 sweep start angle
    alpha0: torch.Tensor         # (W,N) f32 sweep start fraction
    local_center: torch.Tensor   # (W,N,2) f32 center of mass in body frame
    v: torch.Tensor              # (W,N,2) f32 linear velocity (of center)
    w: torch.Tensor              # (W,N) f32 angular velocity
    force: torch.Tensor          # (W,N,2) f32 accumulated force
    torque: torch.Tensor         # (W,N) f32 accumulated torque
    inv_mass: torch.Tensor       # (W,N) f32
    inv_inertia: torch.Tensor    # (W,N) f32 (about center of mass)
    linear_damping: torch.Tensor   # (W,N) f32
    angular_damping: torch.Tensor  # (W,N) f32
    gravity_scale: torch.Tensor    # (W,N) f32
    awake: torch.Tensor          # (W,N) bool
    allow_sleep: torch.Tensor    # (W,N) bool
    fixed_rotation: torch.Tensor  # (W,N) bool
    bullet: torch.Tensor         # (W,N) bool
    enabled: torch.Tensor        # (W,N) bool (reference "active" flag)
    sleep_time: torch.Tensor     # (W,N) f32

    @property
    def capacity(self):
        return self.body_type.shape[-1]

    @property
    def exists(self):
        return self.body_type >= 0

    @property
    def is_dynamic(self):
        from .settings import DYNAMIC_BODY
        return self.body_type == DYNAMIC_BODY

    @property
    def is_static(self):
        from .settings import STATIC_BODY
        return self.body_type == STATIC_BODY

    @property
    def xf_p(self):
        """Body-origin world position (b2Body::GetPosition)."""
        from .math2d import body_xf
        return body_xf(self.c, self.a, self.local_center)[0]


@_frozen
class Fixtures:
    """SoA equivalent of b2Fixture + its shape (reference: b2Fixture.h:100).

      * polygon: verts[0:n], normals[0:n], radius = b2_polygonRadius
      * edge:    verts[0] = v1, verts[1] = v2, verts[2] = ghost v0,
                 verts[3] = ghost v3, ghosts = (has_v0, has_v3)

    `aabb_lo/aabb_hi` is the persistent *fat* broad-phase AABB.
    """

    body: torch.Tensor          # (W,F) i32 body slot, -1 = empty
    shape_type: torch.Tensor    # (W,F) i32 settings.SHAPE_*
    radius: torch.Tensor        # (W,F) f32
    verts: torch.Tensor         # (W,F,8,2) f32 local vertices
    normals: torch.Tensor       # (W,F,8,2) f32 local edge normals (polygon)
    nverts: torch.Tensor        # (W,F) i32
    ghosts: torch.Tensor        # (W,F,2) bool edge ghost-vertex presence
    friction: torch.Tensor      # (W,F) f32
    restitution: torch.Tensor   # (W,F) f32
    density: torch.Tensor       # (W,F) f32
    is_sensor: torch.Tensor     # (W,F) bool
    filter_category: torch.Tensor  # (W,F) i32 (16-bit semantics)
    filter_mask: torch.Tensor      # (W,F) i32
    filter_group: torch.Tensor     # (W,F) i32
    thick_shape: torch.Tensor      # (W,F) bool
    aabb_lo: torch.Tensor       # (W,F,2) f32 fat AABB lower
    aabb_hi: torch.Tensor       # (W,F,2) f32 fat AABB upper

    @property
    def capacity(self):
        return self.body.shape[-1]

    @property
    def exists(self):
        return self.body >= 0


@_frozen
class Contacts:
    """Persistent contact table; slot i holds the i-th pair in canonical
    sorted key order (b2ContactProxyIds determinism, b2Contact.h:65-77)."""

    f_a: torch.Tensor            # (W,C) i32 fixture A, -1 = empty
    f_b: torch.Tensor            # (W,C) i32 fixture B
    m_type: torch.Tensor         # (W,C) i32 manifold type
    m_local_point: torch.Tensor  # (W,C,2) f32
    m_local_normal: torch.Tensor  # (W,C,2) f32
    m_points: torch.Tensor       # (W,C,2,2) f32 manifold local points
    m_ids: torch.Tensor          # (W,C,2) i32 packed contact feature ids
    m_count: torch.Tensor        # (W,C) i32
    normal_impulse: torch.Tensor   # (W,C,2) f32
    tangent_impulse: torch.Tensor  # (W,C,2) f32
    touching: torch.Tensor       # (W,C) bool
    toi_count: torch.Tensor      # (W,C) i32
    tangent_speed: torch.Tensor        # (W,C) f32
    friction_override: torch.Tensor    # (W,C) f32, -1 = unset
    restitution_override: torch.Tensor  # (W,C) f32, -1 = unset

    @property
    def capacity(self):
        return self.f_a.shape[-1]


@_frozen
class SolverCache:
    """Cross-step cache of the graph passes (island labels + coloring),
    keyed on graph signatures exactly as in the JAX package."""

    valid: torch.Tensor          # (W,) bool
    labels: torch.Tensor         # (W,N) i32 island labels
    color: torch.Tensor          # (W,C) i32
    rank: torch.Tensor           # (W,C) i32
    color_overflow: torch.Tensor  # (W,) i32
    sig_solv: torch.Tensor       # (W,C) bool solvable_contact
    sig_ns: torch.Tensor         # (W,N) bool non_static
    sig_jact: torch.Tensor       # (W,J) bool joint actives ((W,1) without joints)
    sig_jba: torch.Tensor        # (W,J) i32
    sig_jbb: torch.Tensor        # (W,J) i32
    sig_f_a: torch.Tensor        # (W,C) i32 pair table identity
    sig_f_b: torch.Tensor        # (W,C) i32
    sig_cc: torch.Tensor         # (W,C) bool cc_active
    sig_dyn_a: torch.Tensor      # (W,C) bool conflicting endpoints
    sig_dyn_b: torch.Tensor      # (W,C) bool


@_frozen
class RevoluteJoints:
    """b2RevoluteJoint (b2RevoluteJoint.h:85-204); leaves (W, J...)."""
    active: torch.Tensor             # (W,J) bool
    body_a: torch.Tensor             # (W,J) i32
    body_b: torch.Tensor             # (W,J) i32
    collide_connected: torch.Tensor  # (W,J) bool
    local_anchor_a: torch.Tensor     # (W,J,2) f32
    local_anchor_b: torch.Tensor     # (W,J,2)
    reference_angle: torch.Tensor    # (W,J)
    enable_limit: torch.Tensor       # (W,J) bool
    lower_angle: torch.Tensor
    upper_angle: torch.Tensor
    enable_motor: torch.Tensor       # (W,J) bool
    motor_speed: torch.Tensor
    max_motor_torque: torch.Tensor
    impulse: torch.Tensor            # (W,J,3) persistent (x, y, angular)
    motor_impulse: torch.Tensor      # (W,J)
    limit_state: torch.Tensor        # (W,J) i32 persistent (b2Joint.h:77-84)


@_frozen
class DistanceJoints:
    """b2DistanceJoint (b2DistanceJoint.h:68-169)."""
    active: torch.Tensor
    body_a: torch.Tensor
    body_b: torch.Tensor
    collide_connected: torch.Tensor
    local_anchor_a: torch.Tensor     # (W,J,2)
    local_anchor_b: torch.Tensor
    length: torch.Tensor
    frequency: torch.Tensor          # Hz; 0 = rigid
    damping_ratio: torch.Tensor
    impulse: torch.Tensor            # (W,J)


@_frozen
class PrismaticJoints:
    """b2PrismaticJoint (b2PrismaticJoint.h:76-196)."""
    active: torch.Tensor
    body_a: torch.Tensor
    body_b: torch.Tensor
    collide_connected: torch.Tensor
    local_anchor_a: torch.Tensor     # (W,J,2)
    local_anchor_b: torch.Tensor
    local_axis_a: torch.Tensor       # (W,J,2)
    reference_angle: torch.Tensor
    enable_limit: torch.Tensor
    lower_translation: torch.Tensor
    upper_translation: torch.Tensor
    enable_motor: torch.Tensor
    motor_speed: torch.Tensor
    max_motor_force: torch.Tensor
    impulse: torch.Tensor            # (W,J,3)
    motor_impulse: torch.Tensor
    limit_state: torch.Tensor        # (W,J) i32 persistent


@_frozen
class MouseJoints:
    """b2MouseJoint (b2MouseJoint.h:36-129)."""
    active: torch.Tensor
    body_a: torch.Tensor             # unused (ground proxy), = body_b
    body_b: torch.Tensor
    collide_connected: torch.Tensor
    target: torch.Tensor             # (W,J,2) world target
    local_anchor_b: torch.Tensor     # (W,J,2)
    max_force: torch.Tensor
    frequency: torch.Tensor
    damping_ratio: torch.Tensor
    impulse: torch.Tensor            # (W,J,2)


@_frozen
class WeldJoints:
    """b2WeldJoint (b2WeldJoint.h:70-126)."""
    active: torch.Tensor
    body_a: torch.Tensor
    body_b: torch.Tensor
    collide_connected: torch.Tensor
    local_anchor_a: torch.Tensor     # (W,J,2)
    local_anchor_b: torch.Tensor
    reference_angle: torch.Tensor
    frequency: torch.Tensor
    damping_ratio: torch.Tensor
    impulse: torch.Tensor            # (W,J,3)


@_frozen
class FrictionJoints:
    """b2FrictionJoint (b2FrictionJoint.h:39-120)."""
    active: torch.Tensor
    body_a: torch.Tensor
    body_b: torch.Tensor
    collide_connected: torch.Tensor
    local_anchor_a: torch.Tensor     # (W,J,2)
    local_anchor_b: torch.Tensor
    max_force: torch.Tensor
    max_torque: torch.Tensor
    linear_impulse: torch.Tensor     # (W,J,2)
    angular_impulse: torch.Tensor    # (W,J)


@_frozen
class RopeJoints:
    """b2RopeJoint (b2RopeJoint.h:39-114)."""
    active: torch.Tensor
    body_a: torch.Tensor
    body_b: torch.Tensor
    collide_connected: torch.Tensor
    local_anchor_a: torch.Tensor     # (W,J,2)
    local_anchor_b: torch.Tensor
    max_length: torch.Tensor
    impulse: torch.Tensor            # (W,J)


@_frozen
class MotorJoints:
    """b2MotorJoint (b2MotorJoint.h:41-133)."""
    active: torch.Tensor
    body_a: torch.Tensor
    body_b: torch.Tensor
    collide_connected: torch.Tensor
    linear_offset: torch.Tensor      # (W,J,2)
    angular_offset: torch.Tensor
    max_force: torch.Tensor
    max_torque: torch.Tensor
    correction_factor: torch.Tensor
    linear_impulse: torch.Tensor     # (W,J,2)
    angular_impulse: torch.Tensor


@_frozen
class WheelJoints:
    """b2WheelJoint (b2WheelJoint.h:77-210)."""
    active: torch.Tensor
    body_a: torch.Tensor
    body_b: torch.Tensor
    collide_connected: torch.Tensor
    local_anchor_a: torch.Tensor     # (W,J,2)
    local_anchor_b: torch.Tensor
    local_axis_a: torch.Tensor       # (W,J,2)
    enable_motor: torch.Tensor       # (W,J) bool
    motor_speed: torch.Tensor
    max_motor_torque: torch.Tensor
    frequency: torch.Tensor
    damping_ratio: torch.Tensor
    impulse: torch.Tensor            # (W,J) point-on-line impulse
    spring_impulse: torch.Tensor     # (W,J)
    motor_impulse: torch.Tensor      # (W,J)


@_frozen
class PulleyJoints:
    """b2PulleyJoint (b2PulleyJoint.h:64-151)."""
    active: torch.Tensor
    body_a: torch.Tensor
    body_b: torch.Tensor
    collide_connected: torch.Tensor
    ground_anchor_a: torch.Tensor    # (W,J,2) world
    ground_anchor_b: torch.Tensor
    local_anchor_a: torch.Tensor
    local_anchor_b: torch.Tensor
    length_a: torch.Tensor
    length_b: torch.Tensor
    ratio: torch.Tensor
    impulse: torch.Tensor            # (W,J)


@_frozen
class GearJoints:
    """b2GearJoint (b2GearJoint.h:38-126): couples two revolute or
    prismatic joints, named by type (0 revolute, 1 prismatic) and slot in
    their blocks. Four bodies: A = joint1.bodyB, C = joint1.bodyA,
    B = joint2.bodyB, D = joint2.bodyA (b2GearJoint.cpp:61-94); the coupled
    joints' anchors, axes and reference angles are copied in at build
    time, as the reference constructor does."""
    active: torch.Tensor
    body_a: torch.Tensor
    body_b: torch.Tensor
    collide_connected: torch.Tensor
    body_c: torch.Tensor             # (W,J) i32 joint1.bodyA
    body_d: torch.Tensor             # (W,J) i32 joint2.bodyA
    joint1_type: torch.Tensor        # (W,J) i32
    joint1_index: torch.Tensor
    joint2_type: torch.Tensor
    joint2_index: torch.Tensor
    local_anchor_a: torch.Tensor     # (W,J,2) joint1's bodyB side
    local_anchor_b: torch.Tensor     # joint2's bodyB side
    local_anchor_c: torch.Tensor     # joint1's bodyA side
    local_anchor_d: torch.Tensor     # joint2's bodyA side
    local_axis_c: torch.Tensor       # (W,J,2) joint1's axis (zero if revolute)
    local_axis_d: torch.Tensor
    reference_angle_a: torch.Tensor
    reference_angle_b: torch.Tensor
    ratio: torch.Tensor
    constant: torch.Tensor
    impulse: torch.Tensor            # (W,J)


@_frozen
class Joints:
    """The typed joint blocks (capacities may be zero)."""
    revolute: RevoluteJoints
    distance: DistanceJoints
    prismatic: PrismaticJoints
    mouse: MouseJoints
    weld: WeldJoints
    friction: FrictionJoints
    rope: RopeJoints
    motor: MotorJoints
    wheel: WheelJoints
    pulley: PulleyJoints
    gear: GearJoints

    @property
    def count(self):
        """Joint slots over all blocks."""
        return sum(getattr(self, name).body_a.shape[-1]
                   for name, _ in JOINT_BLOCKS)


# the JAX package's block order: it fixes the joint coloring, the island
# edges and the cache signatures
JOINT_BLOCKS = (("revolute", RevoluteJoints), ("distance", DistanceJoints),
                ("prismatic", PrismaticJoints), ("mouse", MouseJoints),
                ("weld", WeldJoints), ("friction", FrictionJoints),
                ("rope", RopeJoints), ("motor", MotorJoints),
                ("wheel", WheelJoints), ("pulley", PulleyJoints),
                ("gear", GearJoints))


@_frozen
class State:
    """Complete batched world state."""

    bodies: Bodies
    fixtures: Fixtures
    contacts: Contacts
    joints: Joints
    gravity: torch.Tensor        # (W,2) f32
    inv_dt0: torch.Tensor        # (W,) f32 previous step's 1/dt
    pairs_dirty: torch.Tensor    # (W,) bool — force a pair refresh
    cache: SolverCache

    @property
    def n_worlds(self):
        return self.gravity.shape[0]


_GROUPS = (("bodies", Bodies), ("fixtures", Fixtures),
           ("contacts", Contacts), ("cache", SolverCache))
_TOP = ("gravity", "inv_dt0", "pairs_dirty")


def make_empty_cache(nb: int, nc: int, nj: int, n_worlds: int = 1,
                     device="cuda") -> SolverCache:
    nj = max(nj, 1)
    kw = dict(device=device)
    return SolverCache(
        valid=torch.zeros(n_worlds, dtype=torch.bool, **kw),
        labels=torch.full((n_worlds, nb), -1, dtype=torch.int32, **kw),
        color=torch.full((n_worlds, nc), -1, dtype=torch.int32, **kw),
        rank=torch.zeros(n_worlds, nc, dtype=torch.int32, **kw),
        color_overflow=torch.zeros(n_worlds, dtype=torch.int32, **kw),
        sig_solv=torch.zeros(n_worlds, nc, dtype=torch.bool, **kw),
        sig_ns=torch.zeros(n_worlds, nb, dtype=torch.bool, **kw),
        sig_jact=torch.zeros(n_worlds, nj, dtype=torch.bool, **kw),
        sig_jba=torch.zeros(n_worlds, nj, dtype=torch.int32, **kw),
        sig_jbb=torch.zeros(n_worlds, nj, dtype=torch.int32, **kw),
        sig_f_a=torch.full((n_worlds, nc), -1, dtype=torch.int32, **kw),
        sig_f_b=torch.full((n_worlds, nc), -1, dtype=torch.int32, **kw),
        sig_cc=torch.zeros(n_worlds, nc, dtype=torch.bool, **kw),
        sig_dyn_a=torch.zeros(n_worlds, nc, dtype=torch.bool, **kw),
        sig_dyn_b=torch.zeros(n_worlds, nc, dtype=torch.bool, **kw),
    )


def _map_block(fn, block, cls):
    return cls(**{f.name: fn(getattr(block, f.name))
                  for f in dataclasses.fields(cls)})


def _map_joints(fn, joints) -> Joints:
    """`fn` over the leaves of the blocks of `joints` (any object with the
    JAX package's block and field names)."""
    return Joints(**{name: _map_block(fn, getattr(joints, name), cls)
                     for name, cls in JOINT_BLOCKS})


def map_leaves(fn, state: State) -> State:
    """Apply `fn` to every leaf of `state`; returns a new State."""
    groups = {name: _map_block(fn, getattr(state, name), cls)
              for name, cls in _GROUPS}
    return State(joints=_map_joints(fn, state.joints), **groups,
                 **{k: fn(getattr(state, k)) for k in _TOP})


def state_from_numpy(obj, device="cuda") -> State:
    """Copy a state whose leaves are numpy arrays (or anything
    `np.asarray` accepts) into a `State` of tensors on `device` (the card
    unless the caller asks for another).

    `obj` needs only the JAX package's field names, so
    `jax.tree.map(np.asarray, jax_state)` carries a JAX state across. The
    leaves are COPIED: `np.asarray` of a jax array is read-only and torch
    refuses to share read-only memory. A single-world state (gravity of
    shape (2,)) gains a leading world axis of 1."""
    single = np.ndim(np.asarray(obj.gravity)) == 1

    def conv(x):
        arr = np.array(x, copy=True)
        if single:
            arr = arr[None]
        return torch.from_numpy(arr).to(device)

    groups = {name: _map_block(conv, getattr(obj, name), cls)
              for name, cls in _GROUPS}
    return State(joints=_map_joints(conv, obj.joints), **groups,
                 **{k: conv(getattr(obj, k)) for k in _TOP})


def to_numpy(state: State) -> State:
    """The same State with every leaf copied to a host numpy array."""
    return map_leaves(lambda t: t.detach().cpu().numpy().copy(), state)


def replicate(state: State, n: int) -> State:
    """Tile the world batch n times along the world axis (a one-world
    state becomes n identical worlds)."""
    return map_leaves(
        lambda t: t.repeat((n,) + (1,) * (t.dim() - 1)).contiguous(), state)


def concat_worlds(states) -> State:
    """One batch of the worlds of `states` in order; they must share their
    capacities (freeze them with the same ones)."""
    leaves = [[] for _ in states]
    for out, st in zip(leaves, states):
        map_leaves(lambda t: out.append(t) or t, st)
    it = iter(zip(*leaves))
    return map_leaves(lambda _: torch.cat(next(it)), states[0])


def where_worlds(on: torch.Tensor, new, old):
    """Per world, the worlds of `new` where `on` (W,) bool is set and those
    of `old` elsewhere: two States, or two blocks of one class (Contacts,
    ...), of one shape."""
    def pick(a, b):
        return torch.where(on.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)

    if isinstance(new, State):
        rest = []
        map_leaves(lambda t: rest.append(t) or t, old)
        it = iter(rest)
        return map_leaves(lambda t: pick(t, next(it)), new)
    return type(new)(**{f.name: pick(getattr(new, f.name), getattr(old, f.name))
                        for f in dataclasses.fields(new)})
