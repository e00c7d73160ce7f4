"""Time of impact over lanes: the TOI phase's kernel.

Counterpart of `box2d_mt_tpu/ops/pallas_toi.py` (`time_of_impact_lanes`,
kernel `_kernel` at :48-531): conservative advancement (b2TimeOfImpact,
b2TimeOfImpact.cpp:256-497) for every candidate lane of a TOI round. Two
implementations take exactly the same arguments:

  * `time_of_impact_lanes_plain`: `ops.distance.time_of_impact` in
    PyTorch, modeled on the XLA path the JAX package runs on a CPU
    (world.py:1283-1289). It serves CPU tensors and is the reference the
    kernel is held against.
  * the CUDA kernel `csrc/toi.cu`: one launch, a block an SM, each block
    compacting the active lanes of its span of lanes in shared memory and
    solving them one a thread, 32 a warp.
    `time_of_impact_lanes` launches it for CUDA tensors, and never falls
    back.

Argument contract (all tensors contiguous, on one device; L lanes):

  verts_a, verts_b    (2, 8, L) f32  local vertices, plane-major:
                                     [x | y][vertex][lane]
  count_a, count_b    (L,) i32       vertex counts (1..8)
  radius_a, radius_b  (L,) f32       skin radii
  sweep_a, sweep_b    (8, L) f32     rows lc_x, lc_y, c0_x, c0_y, c_x, c_y,
                                     a0, a: local center and the sweep
                                     from (c0, a0) to (c, a), normalized
                                     to alpha0 = 0
  t_max               (L,) f32       end of the window (1.0 in the step)
  active              (L,) bool      a lane that is False returns
                                     (TOI_UNKNOWN, t_max) without work

Returns (state (L,) i32 of the `distance.TOI_*` codes, t (L,) f32).

The TPU layout (one 24-row f32 blob, lanes padded to 512) is gone: each
field is its own row of L values, so neighbouring threads read
neighbouring addresses.

The passes of a TOI sub-step (b2Island::SolveTOI, b2Island.cpp:385-523)
have two implementations that take the same arguments too:

  * `toi_substep_passes_plain`: eager PyTorch over all lanes at once:
    20 position passes at TOI_BAUMGARTE, each the lanes' constraints and
    then the mini islands' neighbor constraints rank by rank (one host
    read for the largest rank), the velocity constraints at the solved
    pose without warm start, and the velocity iterations in the same
    order. It serves CPU tensors and is the reference the kernel is held
    against.
  * K8, `csrc/toi.cu` `toi_substep_kernel`: one launch, one thread a
    lane, which applies its own constraint and then its kept neighbors
    in slot order, pass after pass, with no host read.
    `toi_substep_passes` launches it for CUDA tensors, and never falls
    back.

Its argument contract (contiguous, on one device; L lanes, N neighbor
contacts; field rows of L or N values):

  solve        (L,) bool       the lane is solved (selected, with a manifold)
  kind         (2, L) i32      manifold type, point count
  manifold     (8, L) f32      local point x, y; local normal x, y; point 0
                               x, y; point 1 x, y
  body         (10, L) f32     inverse mass a, b; inverse inertia a, b;
                               local center a x, y, b x, y; radius a, b
  material     (3, L) f32      friction, restitution, tangent speed
  pose         (6, L) f32      c_a x, y, a_a, c_b x, y, a_b at the TOI
  vel          (6, L) f32      v_a x, y, w_a, v_b x, y, w_b
  nb_span      (2, L) i32      the lane's kept neighbors: their first
                               place in nb_order and their count
  nb_parent    (N,) i32        the lane that keeps the neighbor, -1 for none
  nb_order     (N,) i32        neighbor indices, each lane's kept ones at
                               its span, in slot order
  nb_kind      (4, N) i32      manifold type, point count, the TOI body is
                               the neighbor's endpoint A (1) or B (0), and
                               the parent lane's endpoint A (1) or B (0)
  nb_manifold  (8, N) f32      as manifold
  nb_body      (14, N) f32     the position passes' inverse masses a, b and
                               inertias a, b (the other endpoint's are 0),
                               the velocity passes' four, local centers,
                               radii
  nb_material  (3, N) f32      as material
  nb_other     (6, N) f32      the other endpoint: its center and angle at
                               its tentative advance, its velocity

A lane with kept neighbors is solved. Returns pose (6, L), vel (6, L), the
lanes' impulses (4, L: normal 0, 1, tangent 0, 1), the neighbors'
impulses (4, N) and their copies of the other endpoint's velocity (3, N).
"""

import ctypes

import torch

from .. import cuda_build, settings
from ..cuda_build import entry, need
from ..math2d import add_rows, rot_from_angle, rot_vec, take
from . import distance
from . import solver as csolver
from .sync import HostSyncs

SWEEP_ROWS = 8
NV = 8
# each argument's name, dtype and leading dimensions (the last is L)
_ARGS = (("verts_a", torch.float32, (2, NV)), ("count_a", torch.int32, ()),
         ("radius_a", torch.float32, ()), ("sweep_a", torch.float32, (SWEEP_ROWS,)),
         ("verts_b", torch.float32, (2, NV)), ("count_b", torch.int32, ()),
         ("radius_b", torch.float32, ()), ("sweep_b", torch.float32, (SWEEP_ROWS,)),
         ("t_max", torch.float32, ()), ("active", torch.bool, ()))


def _check(args):
    active = args[-1]
    if active.dim() != 1:
        raise ValueError(f"time_of_impact_lanes: active must be {torch.bool} of shape "
                         f"(L,), got {active.dtype} {tuple(active.shape)}")
    n, device = active.shape[0], active.device
    for (name, dtype, lead), t in zip(_ARGS, args):
        if t.dtype != dtype or t.shape != (*lead, n):
            raise ValueError(f"time_of_impact_lanes: {name} must be {dtype} of "
                             f"shape {(*lead, n)}, got {t.dtype} {tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"time_of_impact_lanes: {name} is on {t.device}, "
                             f"active on {device}")
        if not t.is_contiguous():
            raise ValueError(f"time_of_impact_lanes: {name} must be contiguous")


def time_of_impact_lanes(verts_a, count_a, radius_a, sweep_a,
                         verts_b, count_b, radius_b, sweep_b, t_max, active):
    """Time of impact per lane: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors (see the module docstring)."""
    args = (verts_a, count_a, radius_a, sweep_a, verts_b, count_b, radius_b,
            sweep_b, t_max, active)
    _check(args)
    kind = active.device.type
    if kind == "cuda":
        return _launch(args)
    if kind == "cpu":
        return time_of_impact_lanes_plain(*args)
    raise ValueError(f"time_of_impact_lanes: no implementation for {active.device}")


def _launch(args):
    """One launch of csrc/toi.cu on PyTorch's current stream; raises when
    the launch is refused."""
    active = args[-1]
    device, n = active.device, active.shape[0]
    state = torch.empty(n, dtype=torch.int32, device=device)
    t = torch.empty(n, dtype=torch.float32, device=device)
    cuda_build.call("toi", "toi_launch", device, (*args, state, t), (n,))
    return state, t


def grid(n_lanes):
    """The kernel's grid for `n_lanes` lanes on the current card: (blocks,
    lanes a block). At most one block an SM, so one wave; each block
    compacts the active lanes of its span and solves them 32 a warp."""
    span = ctypes.c_int(0)
    blocks = entry("toi", "toi_grid", (ctypes.c_int, ctypes.POINTER(ctypes.c_int)))(
        n_lanes, ctypes.byref(span))
    return blocks, span.value


def time_of_impact_lanes_plain(verts_a, count_a, radius_a, sweep_a,
                               verts_b, count_b, radius_b, sweep_b, t_max,
                               active, stats=None):
    """PyTorch time of impact (same arguments and results as the kernel);
    `stats` as in `distance.time_of_impact`."""
    def proxy(verts, sweep):
        s = sweep.T
        return (verts.permute(2, 1, 0), s[:, 0:2], s[:, 2:4], s[:, 4:6],
                s[:, 6], s[:, 7])

    va, lca, c0a, ca, a0a, aa = proxy(verts_a, sweep_a)
    vb, lcb, c0b, cb, a0b, ab = proxy(verts_b, sweep_b)
    return distance.time_of_impact(
        va, count_a, radius_a, lca, c0a, ca, a0a, aa,
        vb, count_b, radius_b, lcb, c0b, cb, a0b, ab, t_max, active,
        stats=stats)


TOI_POSITION_PASSES = 20
# K8's arguments: name, dtype, leading dimensions, and the last: L lanes or
# N neighbors
_SUBSTEP_ARGS = (
    ("solve", torch.bool, (), "L"), ("kind", torch.int32, (2,), "L"),
    ("manifold", torch.float32, (8,), "L"), ("body", torch.float32, (10,), "L"),
    ("material", torch.float32, (3,), "L"), ("pose", torch.float32, (6,), "L"),
    ("vel", torch.float32, (6,), "L"), ("nb_span", torch.int32, (2,), "L"),
    ("nb_parent", torch.int32, (), "N"), ("nb_order", torch.int32, (), "N"),
    ("nb_kind", torch.int32, (4,), "N"), ("nb_manifold", torch.float32, (8,), "N"),
    ("nb_body", torch.float32, (14,), "N"), ("nb_material", torch.float32, (3,), "N"),
    ("nb_other", torch.float32, (6,), "N"))
_NB_PARENT = 8              # the argument whose length is N


def _check_substep(args, iterations):
    fn = "toi_substep_passes"
    if len(args) != len(_SUBSTEP_ARGS):
        raise ValueError(f"{fn}: {len(_SUBSTEP_ARGS)} tensors expected, got {len(args)}")
    solve, nb_parent = args[0], args[_NB_PARENT]
    for name, t in (("solve", solve), ("nb_parent", nb_parent)):
        if t.dim() != 1:
            raise ValueError(f"{fn}: {name} must be of shape (L,) or (N,), got "
                             f"{t.dtype} {tuple(t.shape)}")
    n = {"L": solve.shape[0], "N": nb_parent.shape[0]}
    for (name, dtype, lead, last), t in zip(_SUBSTEP_ARGS, args):
        need(fn, name, t, dtype, (*lead, n[last]), solve.device)
    if iterations < 0:
        raise ValueError(f"{fn}: iterations {iterations} must not be negative")


def toi_substep_passes(*args, iterations=8, syncs: HostSyncs = None):
    """The passes of a TOI sub-step (see the module docstring): the plain
    version for CPU tensors, K8 for CUDA tensors, counted as the event
    "toi.substep_kernel" in `syncs`."""
    _check_substep(args, iterations)
    syncs = syncs or HostSyncs()
    kind = args[0].device.type
    if kind == "cuda":
        out = _substep_launch(args, iterations)
        syncs.event("toi.substep_kernel")
        return out
    if kind == "cpu":
        return toi_substep_passes_plain(*args, iterations=iterations, syncs=syncs)
    raise ValueError(f"toi_substep_passes: no implementation for {args[0].device}")


def _substep_launch(args, iterations):
    """One launch of K8 on PyTorch's current stream; raises when the
    launch is refused."""
    n_lanes, n_nb = args[0].shape[0], args[_NB_PARENT].shape[0]
    device = args[0].device
    new = lambda rows, n: torch.empty((rows, n), dtype=torch.float32, device=device)
    out = (new(6, n_lanes), new(6, n_lanes), new(4, n_lanes), new(4, n_nb), new(3, n_nb))
    cuda_build.call("toi", "toi_substep_launch", device, (*args, *out),
                    (n_lanes, n_nb, TOI_POSITION_PASSES, iterations))
    return out


def _velocity_prep(mtype, local_point, local_normal, points, count, cA2, aA2, lcA, ra,
                   cB2, aB2, lcB, rb, mA, mB, iA, iB, vA, wA, vB, wB, rest):
    """Velocity-constraint data of (W, K) lanes at a solved pose (centers
    c, angles a), no warm start (b2ContactSolver's constructor +
    InitializeVelocityConstraints, b2ContactSolver.cpp:142-249). Returns the
    arguments velocity_contact_math_s takes after the masses."""
    qA2 = rot_from_angle(aA2)
    qB2 = rot_from_angle(aB2)
    normal, pts, _ = csolver.world_manifold(
        mtype, local_point, local_normal, points, count,
        cA2 - rot_vec(qA2, lcA), qA2, ra, cB2 - rot_vec(qB2, lcB), qB2, rb)
    r_a = pts - cA2[:, :, None, :]
    r_b = pts - cB2[:, :, None, :]
    nx, ny = normal[..., 0], normal[..., 1]
    rn_a = r_a[..., 0] * ny[..., None] - r_a[..., 1] * nx[..., None]
    rn_b = r_b[..., 0] * ny[..., None] - r_b[..., 1] * nx[..., None]
    k_n = (mA + mB)[..., None] + iA[..., None] * rn_a ** 2 + iB[..., None] * rn_b ** 2
    nm = torch.where(k_n > 0.0, 1.0 / torch.where(k_n > 0.0, k_n, 1.0), 0.0)
    tx, ty = ny, -nx
    rt_a = r_a[..., 0] * ty[..., None] - r_a[..., 1] * tx[..., None]
    rt_b = r_b[..., 0] * ty[..., None] - r_b[..., 1] * tx[..., None]
    k_t = (mA + mB)[..., None] + iA[..., None] * rt_a ** 2 + iB[..., None] * rt_b ** 2
    tm = torch.where(k_t > 0.0, 1.0 / torch.where(k_t > 0.0, k_t, 1.0), 0.0)
    dvx = (vB[..., 0:1] - wB[..., None] * r_b[..., 1]
           - vA[..., 0:1] + wA[..., None] * r_a[..., 1])
    dvy = (vB[..., 1:2] + wB[..., None] * r_b[..., 0]
           - vA[..., 1:2] - wA[..., None] * r_a[..., 0])
    v_rel = dvx * nx[..., None] + dvy * ny[..., None]
    bias = torch.where(v_rel < -settings.VELOCITY_THRESHOLD,
                       -rest[..., None] * v_rel, 0.0)
    k11 = k_n[..., 0]
    k22 = k_n[..., 1]
    k12 = mA + mB + iA * rn_a[..., 0] * rn_a[..., 1] + iB * rn_b[..., 0] * rn_b[..., 1]
    det = k11 * k22 - k12 * k12
    well = k11 * k11 < 1000.0 * det
    pc2 = torch.where((count == 2) & ~well, 1, count)
    inv_det = torch.where(det != 0.0, 1.0 / torch.where(det != 0.0, det, 1.0), 0.0)
    return (nx, ny,
            (r_a[..., 0, 0], r_a[..., 1, 0]), (r_a[..., 0, 1], r_a[..., 1, 1]),
            (r_b[..., 0, 0], r_b[..., 1, 0]), (r_b[..., 0, 1], r_b[..., 1, 1]),
            (nm[..., 0], nm[..., 1]), (tm[..., 0], tm[..., 1]),
            (bias[..., 0], bias[..., 1]),
            k11, k12, k22, inv_det * k22, -inv_det * k12, inv_det * k11, pc2)


class _Contacts:
    """Field rows as the plain passes take them: each row (1, n), one
    world of n lanes, as the step's (W, K) tensors were."""

    def __init__(self, kind, manifold, material):
        self.mtype, self.count = kind[:2, None]
        lp = manifold[0:2].T[None]
        ln = manifold[2:4].T[None]
        pts = manifold[4:8].reshape(2, 2, -1).permute(2, 0, 1)[None]
        self.manifold = (self.mtype, lp, ln, pts, self.count)
        self.fric, self.rest, self.ts = material[:, None]

    def position_args(self, lc_a, lc_b, ra, rb):
        """position_contact_math_s's per-lane constants."""
        _, lp, ln, pts, _ = self.manifold
        return (ra, rb, lc_a[..., 0], lc_a[..., 1], lc_b[..., 0], lc_b[..., 1],
                lp[..., 0], lp[..., 1], ln[..., 0], ln[..., 1],
                (pts[..., 0, 0], pts[..., 1, 0]), (pts[..., 0, 1], pts[..., 1, 1]))


class _Neighbors:
    """The mini islands' constraints in the plain passes: each solved
    lane's kept neighbor contacts, applied one rank after another (within
    a rank a lane has at most one neighbor, so every scatter there has one
    writer per row). In the position passes only the TOI body moves
    (SolveTOIPositionConstraints, b2ContactSolver.cpp:780-806); the velocity
    passes use real masses, and each neighbor carries its own copy of the
    other endpoint's velocity."""

    def __init__(self, nb_span, nb_parent, nb_order, nb_kind, nb_manifold, nb_body,
                 nb_material, nb_other, syncs):
        n = nb_parent.shape[0]
        dev = nb_parent.device
        self.c = _Contacts(nb_kind, nb_manifold, nb_material)
        self.keep = (nb_parent >= 0)[None]
        self.nparent = nb_parent.clamp_min(0).long()[None]
        # rank of each kept neighbor among its parent's, in slot order
        place = torch.empty(n, dtype=torch.long, device=dev)
        place[nb_order.long()] = torch.arange(n, device=dev)
        self.rank = place[None] - take(nb_span[0, None].long(), self.nparent)
        self.max_rank = syncs.value(nb_span[1].max())
        self.n_toi_a = (nb_kind[2] != 0)[None]
        self.side_a = (nb_kind[3] != 0)[None]
        rows = nb_body[:, None]
        self.p_mass, self.v_mass = rows[0:4], rows[4:8]
        self.lcA = torch.stack(tuple(rows[8:10]), -1)
        self.lcB = torch.stack(tuple(rows[10:12]), -1)
        self.ra, self.rb = rows[12:14]
        self.pos_args = self.c.position_args(self.lcA, self.lcB, self.ra, self.rb)
        other = nb_other[:, None]
        self.o_ce = torch.stack(tuple(other[0:2]), -1)
        self.o_ae = other[2]
        self.o_v = torch.stack(tuple(other[3:5]), -1)
        self.o_w = other[5]

    def _own(self, lane_vals):
        """The TOI body's three values out of its parent lane's six."""
        return torch.where(self.side_a[..., None], lane_vals[..., 0:3], lane_vals[..., 3:6])

    def _poses(self, tpos):
        """(cA, aA, cB, aB) of the neighbor contacts: the TOI body at
        `tpos` (1, N, 3), the other endpoint at its tentative advance."""
        a2 = self.n_toi_a[..., None]
        return (torch.where(a2, tpos[..., 0:2], self.o_ce),
                torch.where(self.n_toi_a, tpos[..., 2], self.o_ae),
                torch.where(a2, self.o_ce, tpos[..., 0:2]),
                torch.where(self.n_toi_a, self.o_ae, tpos[..., 2]))

    def _scatter_own(self, lanes6, d3):
        """Add the TOI-body deltas d3 (1, N, 3) into their parents' slot of
        lanes6 (1, L, 6)."""
        z3 = torch.zeros_like(d3)
        d6 = torch.where(self.side_a[..., None], torch.cat([d3, z3], -1),
                         torch.cat([z3, d3], -1))
        return add_rows(lanes6, self.nparent, d6)

    def position_passes(self, pos):
        """The neighbor constraints against the live TOI-body pose, one
        rank after another (the neighbor endpoint has zero mass here)."""
        lane_pos = torch.stack(pos, -1)
        a = self.n_toi_a
        for r in range(self.max_rank):
            act = self.keep & (self.rank == r)
            cA, aA, cB, aB = self._poses(self._own(take(lane_pos, self.nparent)))
            before = (cA[..., 0], cA[..., 1], aA, cB[..., 0], cB[..., 1], aB)
            after = csolver.position_contact_math_s(
                self.c.mtype, self.c.count, *self.p_mass, *self.pos_args,
                *before, act, settings.TOI_BAUMGARTE, settings.MAX_LINEAR_CORRECTION)
            d3 = torch.stack([torch.where(a, after[i] - before[i], after[i + 3] - before[i + 3])
                              for i in range(3)], -1)
            lane_pos = self._scatter_own(lane_pos, d3)
        return tuple(lane_pos.unbind(-1))

    def prepare_velocity(self, pos, vA, wA, vB, wB):
        """Velocity-constraint data at the position-solved TOI-body pose,
        with real masses on both endpoints."""
        cA, aA, cB, aB = self._poses(self._own(take(torch.stack(pos, -1), self.nparent)))
        tv0 = self._own(take(torch.stack([vA[..., 0], vA[..., 1], wA, vB[..., 0],
                                          vB[..., 1], wB], -1), self.nparent))
        a2 = self.n_toi_a[..., None]
        nvA0 = torch.where(a2, tv0[..., 0:2], self.o_v)
        nwA0 = torch.where(self.n_toi_a, tv0[..., 2], self.o_w)
        nvB0 = torch.where(a2, self.o_v, tv0[..., 0:2])
        nwB0 = torch.where(self.n_toi_a, self.o_w, tv0[..., 2])
        self.vel_args = _velocity_prep(
            *self.c.manifold, cA, aA, self.lcA, self.ra, cB, aB, self.lcB, self.rb,
            *self.v_mass, nvA0, nwA0, nvB0, nwB0, self.c.rest)
        zero = torch.zeros_like(self.c.fric)
        self.nn, self.nt = (zero, zero), (zero, zero)
        self.o_vel = (self.o_v[..., 0], self.o_v[..., 1], self.o_w)

    def velocity_passes(self, vel):
        """The neighbor impulses against the live TOI-body velocity, one
        rank after another; the other endpoint carries its own velocity
        copy and receives impulses too."""
        lane_vel = torch.stack(vel, -1)
        a = self.n_toi_a
        for r in range(self.max_rank):
            act = self.keep & (self.rank == r)
            tv = self._own(take(lane_vel, self.nparent))
            ovx, ovy, ow = self.o_vel
            before = (torch.where(a, tv[..., 0], ovx), torch.where(a, tv[..., 1], ovy),
                      torch.where(a, tv[..., 2], ow), torch.where(a, ovx, tv[..., 0]),
                      torch.where(a, ovy, tv[..., 1]), torch.where(a, ow, tv[..., 2]))
            self.nn, self.nt, *after = csolver.velocity_contact_math_s(
                self.c.fric, self.c.ts, *self.v_mass, *self.vel_args, self.nn, self.nt,
                *before, act)
            d3 = torch.stack([torch.where(a, after[i] - before[i], after[i + 3] - before[i + 3])
                              for i in range(3)], -1)
            lane_vel = self._scatter_own(lane_vel, d3)
            self.o_vel = tuple(
                torch.where(act & a, after[i + 3], torch.where(act & ~a, after[i], o))
                for i, o in enumerate(self.o_vel))
        return tuple(lane_vel.unbind(-1))


def toi_substep_passes_plain(solve, kind, manifold, body, material, pose, vel, nb_span,
                             nb_parent, nb_order, nb_kind, nb_manifold, nb_body,
                             nb_material, nb_other, iterations=8,
                             syncs: HostSyncs = None):
    """PyTorch passes of a TOI sub-step (same arguments and results as K8);
    with neighbors, the largest rank is one host read in `syncs`."""
    syncs = syncs or HostSyncs()
    lanes = _Contacts(kind, manifold, material)
    mA, mB, iA, iB = body[0:4, None]
    lcA = torch.stack(tuple(body[4:6, None]), -1)
    lcB = torch.stack(tuple(body[6:8, None]), -1)
    ra, rb = body[8:10, None]
    on = solve[None]
    island = (_Neighbors(nb_span, nb_parent, nb_order, nb_kind, nb_manifold, nb_body,
                         nb_material, nb_other, syncs)
              if nb_parent.shape[0] else None)

    # ---- TOI position sub-solve: 20 passes at beta = 0.75
    pos_args = lanes.position_args(lcA, lcB, ra, rb)
    pos = tuple(pose[:, None])
    for _ in range(TOI_POSITION_PASSES):
        pos = csolver.position_contact_math_s(
            lanes.mtype, lanes.count, mA, mB, iA, iB, *pos_args, *pos, on,
            settings.TOI_BAUMGARTE, settings.MAX_LINEAR_CORRECTION)[:6]
        if island is not None:
            pos = island.position_passes(pos)
    cax, cay, aa_, cbx, cby, ab_ = pos

    # ---- velocity sub-solve (no warm start) at the solved pose
    vA = torch.stack(tuple(vel[0:2, None]), -1)
    vB = torch.stack(tuple(vel[3:5, None]), -1)
    wA, wB = vel[2, None], vel[5, None]
    vel_args = _velocity_prep(
        *lanes.manifold, torch.stack([cax, cay], -1), aa_, lcA, ra,
        torch.stack([cbx, cby], -1), ab_, lcB, rb, mA, mB, iA, iB,
        vA, wA, vB, wB, lanes.rest)
    if island is not None:
        island.prepare_velocity(pos, vA, wA, vB, wB)
    zero = torch.zeros_like(lanes.fric)
    ni, ti = (zero, zero), (zero, zero)
    v = tuple(vel[:, None])
    for _ in range(iterations):
        ni, ti, *v = csolver.velocity_contact_math_s(
            lanes.fric, lanes.ts, mA, mB, iA, iB, *vel_args, ni, ti, *v, on)
        if island is not None:
            v = island.velocity_passes(v)
    if island is None:
        nb_imp = torch.zeros((4, nb_parent.shape[0]), device=pose.device)
        nb_vel = nb_other[3:6].clone()
    else:
        nb_imp = torch.cat([*island.nn, *island.nt])
        nb_vel = torch.cat(island.o_vel)
    return torch.cat(pos), torch.cat(v), torch.cat([*ni, *ti]), nb_imp, nb_vel
