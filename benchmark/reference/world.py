"""One step of a batch of Box2D 2.3.1 worlds, written from its semantics
in plain PyTorch: b2World::Step without joints, as b2ContactManager::
Collide, b2World::Solve with b2Island::Solve and b2ContactSolver
(sequential impulses with warm starting, friction, the 2-point block
solver, NGS position correction) and the sleep rule, for one batch.

What it takes, and what it derives itself:
  * the bodies' poses, velocities, awake flags and sleep times before the
    step, and the contacts' feature ids and impulses of the last step (to
    warm-start): the state the step starts from;
  * `order`: each contact's color, the order in which the solver visits
    the constraints; colors are solved one after another, and the
    constraints of one color share no dynamic body, so a color is solved
    as one sequential pass would solve it. Where none is given, or the
    one given is no valid order (two constraints of a color share a
    dynamic body, or a solved contact has none), a greedy coloring of the
    reference's own is used;
  * everything else (the pairs, the manifolds, the islands, the solve,
    the sleep rule) from the worlds' shapes and masses as the reference's
    builder made them.

The position loop runs its `position_iterations` whole, as the
configuration states (b2Island::Solve leaves it early once the contacts
are within 3 slops; the program under test always runs it out). An
island's positionSolved is the last pass's minimum separation within
-3 slops. The TOI phase (b2World::SolveTOI) is not stepped: `toi_bodies`
marks the awake dynamic bodies near enough a static edge for it to move
them."""

import dataclasses

import numpy as np
import torch

from . import geometry as g

TIME_TO_SLEEP = 0.5
LINEAR_SLEEP_TOL = 0.01
ANGULAR_SLEEP_TOL = 2.0 / 180.0 * np.pi
VELOCITY_THRESHOLD = 1.0
BAUMGARTE = 0.2
MAX_LINEAR_CORRECTION = 0.2
MAX_TRANSLATION = 2.0
MAX_ROTATION = 0.5 * np.pi
TOI_TARGET = g.LINEAR_SLOP             # max(slop, 2 radii - 3 slops) for two skins of 0.01
TOI_TOLERANCE = 0.25 * g.LINEAR_SLOP
TOI_WATCH = TOI_TARGET + TOI_TOLERANCE + g.LINEAR_SLOP
AABB_SLACK = 1e-3
SLEEP_REL_BAND = 1e-3
SLEEP_SEP_BAND = 2e-5


@dataclasses.dataclass
class Structure:
    """What every world of a batch shares: bodies and fixtures as the
    builder made them (float64)."""
    body_type: torch.Tensor      # (N,) long
    inv_mass: torch.Tensor       # (N,)
    inv_inertia: torch.Tensor    # (N,)
    local_center: torch.Tensor   # (N, 2)
    rmax: torch.Tensor           # (N,) largest distance of a fixture point from the center
    fix_body: torch.Tensor       # (F,) long
    fix_type: torch.Tensor       # (F,) long
    verts: torch.Tensor          # (F, K, 2)
    normals: torch.Tensor        # (F, K, 2)
    count: torch.Tensor          # (F,) long
    radius: torch.Tensor         # (F,)
    friction: torch.Tensor       # (F,)
    restitution: torch.Tensor    # (F,)
    centroid: torch.Tensor       # (F, 2)
    pair_a: torch.Tensor         # (Q,) long: fixture pairs that may collide, A as Box2D orders it
    pair_b: torch.Tensor         # (Q,)
    watch_body: torch.Tensor     # (S,) long: (dynamic body, static edge) pairs for the TOI watch
    watch_fix: torch.Tensor      # (S,)


@dataclasses.dataclass
class Contacts:
    """Touching pairs, flat over worlds, sorted by `keys`."""
    world: torch.Tensor          # (M,) long
    fa: torch.Tensor
    fb: torch.Tensor
    ids: torch.Tensor            # (M, 2) long feature keys
    count: torch.Tensor          # (M,) long
    ni: torch.Tensor             # (M, 2)
    ti: torch.Tensor             # (M, 2)

    def keys(self, nf):
        return pair_keys(self.world, self.fa, self.fb, nf)

    def select(self, keep):
        return Contacts(*(getattr(self, f.name)[keep] for f in dataclasses.fields(self)))

    @staticmethod
    def empty(device, dtype):
        z = torch.zeros(0, dtype=torch.long, device=device)
        f = torch.zeros((0, 2), dtype=dtype, device=device)
        return Contacts(z, z, z, torch.zeros((0, 2), dtype=torch.long, device=device), z, f, f)

    @staticmethod
    def cat(parts):
        return Contacts(*(torch.cat([getattr(p, f.name) for p in parts])
                          for f in dataclasses.fields(Contacts)))


def pair_keys(world, fa, fb, nf):
    return (world * nf + fa) * nf + fb


def sort_contacts(c: Contacts, nf) -> Contacts:
    order = torch.argsort(c.keys(nf))
    return c.select(order)


@dataclasses.dataclass
class Bodies:
    c: torch.Tensor              # (W, N, 2)
    a: torch.Tensor              # (W, N)
    v: torch.Tensor
    w: torch.Tensor
    awake: torch.Tensor          # (W, N) bool
    sleep_time: torch.Tensor     # (W, N) float32, as b2Body::m_sleepTime


@dataclasses.dataclass
class StepOut:
    bodies: Bodies
    contacts: Contacts           # touching pairs after the step, with their impulses
    margin: torch.Tensor         # (W,) least margin of a collider's discontinuous decision
    sleep_edge: torch.Tensor     # (W,) bool: a sleep decision on its threshold
    toi_bodies: torch.Tensor     # (W, N) bool: bodies the TOI phase may move
    order_fallback: torch.Tensor  # (W,) bool: the order given was no valid order


# ------------------------------------------------------------- helpers

def transforms(st: Structure, c, a):
    s, co = torch.sin(a), torch.cos(a)
    lx, ly = g.rot(s, co, st.local_center[:, 0], st.local_center[:, 1])
    p = torch.stack([c[..., 0] - lx, c[..., 1] - ly], -1)
    return p, s, co


def fixture_aabbs(st: Structure, p, s, co):
    """(W, F, 2) lower and upper bounds of every fixture's skin."""
    fb = st.fix_body
    wv = g.apply_xf(p[:, fb], s[:, fb], co[:, fb], st.verts[None].expand(p.shape[0], -1, -1, -1))
    ok = (torch.arange(st.verts.shape[1], device=p.device)[None, :] < st.count[:, None])[None, ..., None]
    lo = torch.where(ok, wv, g.BIG).amin(2) - st.radius[None, :, None]
    hi = torch.where(ok, wv, -g.BIG).amax(2) + st.radius[None, :, None]
    return lo, hi


def cross_sv(s, v):
    """b2Cross(s, v) = (-s * v.y, s * v.x)."""
    return torch.stack([-s * v[..., 1], s * v[..., 0]], -1)


def cross_vv(a, b):
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


# ------------------------------------------------------------- collide

def collide(st: Structure, p, s, co, prefer=None, band=0.0):
    """Every pair of the batch whose skins' bounds meet (within AABB_SLACK):
    (world, fa, fb) and the pairs' manifolds. `prefer(world, fa, fb)`:
    the manifold type to take where a polygon pair's choice of reference
    face lies within `band` of its threshold (see
    geometry.collide_polygons)."""
    lo, hi = fixture_aabbs(st, p, s, co)
    qa, qb = st.pair_a, st.pair_b
    meet = ((lo[:, qa] <= hi[:, qb] + AABB_SLACK) & (lo[:, qb] <= hi[:, qa] + AABB_SLACK)).all(-1)
    world, q = torch.nonzero(meet, as_tuple=True)
    fa, fb = qa[q], qb[q]
    ba, bb = st.fix_body[fa], st.fix_body[fb]
    pa, sa, ca = p[world, ba], s[world, ba], co[world, ba]
    pb, sb, cb = p[world, bb], s[world, bb], co[world, bb]
    n = world.shape[0]
    dt = p.dtype
    man = g.Manifold(torch.zeros(n, dtype=torch.long, device=p.device),
                     torch.zeros((n, 2), dtype=dt, device=p.device),
                     torch.zeros((n, 2), dtype=dt, device=p.device),
                     torch.zeros((n, 2, 2), dtype=dt, device=p.device),
                     torch.zeros((n, 2), dtype=torch.long, device=p.device),
                     torch.zeros(n, dtype=torch.long, device=p.device),
                     torch.full((n,), g.BIG, dtype=dt, device=p.device))
    ta, tb = st.fix_type[fa], st.fix_type[fb]
    kinds = {(g.POLYGON, g.POLYGON): "pp", (g.EDGE, g.POLYGON): "ep"}
    for (ka, kb), kind in kinds.items():
        sel = torch.nonzero((ta == ka) & (tb == kb), as_tuple=True)[0]
        if not sel.numel():
            continue
        fas, fbs = fa[sel], fb[sel]
        b = {"verts": st.verts[fbs], "normals": st.normals[fbs], "count": st.count[fbs],
             "radius": st.radius[fbs], "centroid": st.centroid[fbs]}
        if kind == "pp":
            a = {"verts": st.verts[fas], "normals": st.normals[fas], "count": st.count[fas],
                 "radius": st.radius[fas]}
            pref = prefer(world[sel], fas, fbs) if prefer is not None else None
            m = g.collide_polygons(a, pa[sel], sa[sel], ca[sel], b, pb[sel], sb[sel], cb[sel],
                                   pref, band)
        else:
            e = {"v1": st.verts[fas, 0], "v2": st.verts[fas, 1]}
            m = g.collide_edge_polygon(e, pa[sel], sa[sel], ca[sel], b, pb[sel], sb[sel], cb[sel])
        for f in ("mtype", "local_normal", "local_point", "points", "ids", "count", "margin"):
            getattr(man, f)[sel] = getattr(m, f)
    other = ~(((ta == g.POLYGON) & (tb == g.POLYGON)) | ((ta == g.EDGE) & (tb == g.POLYGON)))
    if bool(other.any()):
        raise NotImplementedError("the reference collides polygons and lone edges only")
    return world, fa, fb, man


def match_old(world, fa, fb, man, old: Contacts, nf):
    """b2Contact::Update's impulse carry-over: each new point takes the
    impulses of the old point with its feature key, in the same pair.
    Returns (ni, ti (P, 2) as stored, was_touching (P,))."""
    keys = pair_keys(world, fa, fb, nf)
    okeys = old.keys(nf)
    if okeys.numel():
        pos = torch.searchsorted(okeys, keys).clamp_max(okeys.numel() - 1)
        hit = okeys[pos] == keys
    else:
        pos = torch.zeros_like(keys)
        hit = torch.zeros_like(keys, dtype=torch.bool)
    z = torch.zeros((keys.numel(), 2), dtype=man.points.dtype, device=keys.device)
    if not okeys.numel():
        return z, z.clone(), hit
    oids, ocount = old.ids[pos], old.count[pos]
    oni, oti = old.ni[pos], old.ti[pos]
    two = torch.arange(2, device=keys.device)
    new_ok = two[None] < man.count[:, None]
    old_ok = (two[None] < ocount[:, None]) & hit[:, None]
    same = (man.ids[:, :, None] == oids[:, None, :]) & new_ok[:, :, None] & old_ok[:, None, :]
    m0, m1 = same[..., 0], same[..., 1] & ~same[..., 0]
    ni = torch.where(m0, oni[:, None, 0], torch.where(m1, oni[:, None, 1], 0.0))
    ti = torch.where(m0, oti[:, None, 0], torch.where(m1, oti[:, None, 1], 0.0))
    return ni, ti, hit & (ocount > 0)


# ---------------------------------------------------------- islands

def components(n, ea, eb):
    """Connected components of n nodes under edges (ea, eb): the least
    node of each component, a node."""
    lab = torch.arange(n, device=ea.device)
    if not ea.numel():
        return lab
    while True:
        m = torch.minimum(lab[ea], lab[eb])
        new = lab.clone()
        new.scatter_reduce_(0, ea, m, "amin")
        new.scatter_reduce_(0, eb, m, "amin")
        new = new[new]
        if torch.equal(new, lab):
            return lab
        lab = new


def greedy_colors(world, ba, bb, dyn_a, dyn_b, nw, nbody, device):
    """A greedy coloring in the given order, world by world: each
    constraint takes the least color that no earlier constraint of its
    dynamic bodies took."""
    k = world.numel()
    color = torch.zeros(k, dtype=torch.long, device=device)
    if not k:
        return color
    first = torch.searchsorted(world, torch.arange(nw, device=device))
    rank = torch.arange(k, device=device) - first[world]
    used = torch.zeros(nw * nbody + 1, dtype=torch.long, device=device)
    dump = nw * nbody
    ia = torch.where(dyn_a, ba, dump)
    ib = torch.where(dyn_b, bb, dump)
    for r in range(int(rank.max()) + 1):
        sel = torch.nonzero(rank == r, as_tuple=True)[0]
        taken = (used[ia[sel]] | used[ib[sel]]) & ~used[dump]
        free = ~taken
        col = torch.log2((free & -free).double()).long()
        color[sel] = col
        bit = torch.ones_like(col) << col
        used[ia[sel]] |= bit
        used[ib[sel]] |= bit
        used[dump] = 0
    return color


# ------------------------------------------------------------- solver

class Constraints:
    """b2ContactVelocityConstraint and b2ContactPositionConstraint of the
    K solved contacts, flat over worlds; bodies index the flat (W*N,)."""


def prepare(st, world, fa, fb, man, ni, ti, c, a, v, w, dt_ratio, warm):
    cc = Constraints()
    nb = st.body_type.numel()
    ba, bb = st.fix_body[fa], st.fix_body[fb]
    cc.ba, cc.bb = world * nb + ba, world * nb + bb
    cc.dyn_a, cc.dyn_b = st.body_type[ba] == g.DYNAMIC, st.body_type[bb] == g.DYNAMIC
    cc.ma, cc.mb = st.inv_mass[ba], st.inv_mass[bb]
    cc.ia, cc.ib = st.inv_inertia[ba], st.inv_inertia[bb]
    cc.lca, cc.lcb = st.local_center[ba], st.local_center[bb]
    cc.ra_shape, cc.rb_shape = st.radius[fa], st.radius[fb]
    cc.friction = torch.sqrt(st.friction[fa] * st.friction[fb])
    cc.restitution = torch.maximum(st.restitution[fa], st.restitution[fb])
    cc.mtype, cc.ln, cc.lp = man.mtype, man.local_normal, man.local_point
    cc.lps, cc.pc = man.points, man.count
    cf, af, vf, wf = c.reshape(-1, 2), a.reshape(-1), v.reshape(-1, 2), w.reshape(-1)
    ca_, cb_ = cf[cc.ba], cf[cc.bb]
    pa, sa, coa = _xf(ca_, af[cc.ba], cc.lca)
    pb, sb, cob = _xf(cb_, af[cc.bb], cc.lcb)
    normal, points = world_manifold(cc, pa, sa, coa, pb, sb, cob)
    cc.normal = normal
    cc.rA = points - ca_[:, None]
    cc.rB = points - cb_[:, None]
    tangent = g.cross_vs(normal, torch.ones_like(cc.ma))
    rna, rnb = cross_vv(cc.rA, normal[:, None]), cross_vv(cc.rB, normal[:, None])
    msum = (cc.ma + cc.mb)[:, None]
    kn = msum + cc.ia[:, None] * rna * rna + cc.ib[:, None] * rnb * rnb
    cc.nmass = torch.where(kn > 0, 1.0 / torch.where(kn > 0, kn, 1.0), 0.0)
    rta, rtb = cross_vv(cc.rA, tangent[:, None]), cross_vv(cc.rB, tangent[:, None])
    kt = msum + cc.ia[:, None] * rta * rta + cc.ib[:, None] * rtb * rtb
    cc.tmass = torch.where(kt > 0, 1.0 / torch.where(kt > 0, kt, 1.0), 0.0)
    va, vb, wa, wb = vf[cc.ba], vf[cc.bb], wf[cc.ba], wf[cc.bb]
    dv = vb[:, None] + cross_sv(wb[:, None], cc.rB) - va[:, None] - cross_sv(wa[:, None], cc.rA)
    vrel = g.dot(normal[:, None], dv)
    cc.bias = torch.where(vrel < -VELOCITY_THRESHOLD, -cc.restitution[:, None] * vrel, 0.0)
    k11 = kn[:, 0]
    k22 = kn[:, 1]
    k12 = msum[:, 0] + cc.ia * rna[:, 0] * rna[:, 1] + cc.ib * rnb[:, 0] * rnb[:, 1]
    det = k11 * k22 - k12 * k12
    good = k11 * k11 < 1000.0 * det
    cc.vc = torch.where((cc.pc == 2) & ~good, 1, cc.pc)
    inv = torch.where(det != 0, 1.0 / torch.where(det != 0, det, 1.0), 0.0)
    cc.k11, cc.k12, cc.k22 = k11, k12, k22
    cc.nm11, cc.nm12, cc.nm22 = inv * k22, -inv * k12, inv * k11
    scale = dt_ratio[world][:, None] if warm else torch.zeros_like(ni)
    cc.ni, cc.ti = scale * ni, scale * ti
    return cc


def _xf(c, a, lc):
    s, co = torch.sin(a), torch.cos(a)
    lx, ly = g.rot(s, co, lc[:, 0], lc[:, 1])
    return torch.stack([c[:, 0] - lx, c[:, 1] - ly], -1), s, co


def world_manifold(cc, pa, sa, ca, pb, sb, cb):
    """b2WorldManifold::Initialize for face manifolds: normal (K, 2) and
    the points (K, 2, 2)."""
    face_a = (cc.mtype == g.FACE_A)[:, None]
    s_ref, c_ref = torch.where(face_a[:, 0], sa, sb), torch.where(face_a[:, 0], ca, cb)
    p_ref = torch.where(face_a, pa, pb)
    s_inc, c_inc = torch.where(face_a[:, 0], sb, sa), torch.where(face_a[:, 0], cb, ca)
    p_inc = torch.where(face_a, pb, pa)
    r_ref = torch.where(face_a[:, 0], cc.ra_shape, cc.rb_shape)
    r_inc = torch.where(face_a[:, 0], cc.rb_shape, cc.ra_shape)
    normal = g.apply_rot(s_ref, c_ref, cc.ln[:, None])[:, 0]
    plane = g.apply_xf(p_ref, s_ref, c_ref, cc.lp[:, None])[:, 0]
    clip_p = g.apply_xf(p_inc, s_inc, c_inc, cc.lps)
    on_ref = clip_p + (r_ref[:, None] - g.dot(clip_p - plane[:, None], normal[:, None]))[..., None] \
        * normal[:, None]
    on_inc = clip_p - r_inc[:, None, None] * normal[:, None]
    points = 0.5 * (on_ref + on_inc)
    return torch.where(face_a, normal, -normal), points


def warm_start(cc, vf, wf):
    tangent = g.cross_vs(cc.normal, torch.ones_like(cc.ma))
    has = torch.arange(2, device=vf.device)[None] < cc.vc[:, None]
    P = torch.where(has[..., None], cc.ni[..., None] * cc.normal[:, None]
                    + cc.ti[..., None] * tangent[:, None], 0.0)
    vf.index_add_(0, cc.ba, -cc.ma[:, None] * P.sum(1))
    wf.index_add_(0, cc.ba, -cc.ia * cross_vv(cc.rA, P).sum(1))
    vf.index_add_(0, cc.bb, cc.mb[:, None] * P.sum(1))
    wf.index_add_(0, cc.bb, cc.ib * cross_vv(cc.rB, P).sum(1))


def _apply(vf, wf, idx, dyn, va, wa):
    sel = torch.nonzero(dyn, as_tuple=True)[0]
    vf[idx[sel]] = va[sel]
    wf[idx[sel]] = wa[sel]


def velocity_pass(cc, sel, vf, wf):
    """b2ContactSolver::SolveVelocityConstraints over the constraints
    `sel`, which share no dynamic body."""
    ba, bb = cc.ba[sel], cc.bb[sel]
    va, wa, vb, wb = vf[ba], wf[ba], vf[bb], wf[bb]
    ma, mb, ia, ib = cc.ma[sel, None], cc.mb[sel, None], cc.ia[sel], cc.ib[sel]
    n = cc.normal[sel]
    t = g.cross_vs(n, torch.ones_like(ia))
    rA, rB = cc.rA[sel], cc.rB[sel]
    vc = cc.vc[sel]
    ni, ti = cc.ni[sel].clone(), cc.ti[sel].clone()
    for j in range(2):
        has = j < vc
        dv = vb + cross_sv(wb, rB[:, j]) - va - cross_sv(wa, rA[:, j])
        vt = g.dot(dv, t)
        lam = cc.tmass[sel, j] * (-vt)
        maxf = cc.friction[sel] * ni[:, j]
        new = torch.clamp(ti[:, j] + lam, -maxf, maxf)
        lam = torch.where(has, new - ti[:, j], 0.0)
        ti[:, j] = torch.where(has, new, ti[:, j])
        P = lam[:, None] * t
        va, wa = va - ma * P, wa - ia * cross_vv(rA[:, j], P)
        vb, wb = vb + mb * P, wb + ib * cross_vv(rB[:, j], P)
    bias = cc.bias[sel]
    one = vc == 1
    dv = vb + cross_sv(wb, rB[:, 0]) - va - cross_sv(wa, rA[:, 0])
    vn = g.dot(dv, n)
    lam = -cc.nmass[sel, 0] * (vn - bias[:, 0])
    new = torch.clamp_min(ni[:, 0] + lam, 0.0)
    lam = torch.where(one, new - ni[:, 0], 0.0)
    ni[:, 0] = torch.where(one, new, ni[:, 0])
    P = lam[:, None] * n
    va, wa = va - ma * P, wa - ia * cross_vv(rA[:, 0], P)
    vb, wb = vb + mb * P, wb + ib * cross_vv(rB[:, 0], P)

    two = vc == 2
    a1, a2 = ni[:, 0], ni[:, 1]
    dv1 = vb + cross_sv(wb, rB[:, 0]) - va - cross_sv(wa, rA[:, 0])
    dv2 = vb + cross_sv(wb, rB[:, 1]) - va - cross_sv(wa, rA[:, 1])
    k11, k12, k22 = cc.k11[sel], cc.k12[sel], cc.k22[sel]
    b1 = g.dot(dv1, n) - bias[:, 0] - (k11 * a1 + k12 * a2)
    b2 = g.dot(dv2, n) - bias[:, 1] - (k12 * a1 + k22 * a2)
    nm11, nm12, nm22 = cc.nm11[sel], cc.nm12[sel], cc.nm22[sel]
    x1c1, x2c1 = -(nm11 * b1 + nm12 * b2), -(nm12 * b1 + nm22 * b2)
    ok1 = (x1c1 >= 0) & (x2c1 >= 0)
    x1c2 = -cc.nmass[sel, 0] * b1
    ok2 = (x1c2 >= 0) & (k12 * x1c2 + b2 >= 0)
    x2c3 = -cc.nmass[sel, 1] * b2
    ok3 = (x2c3 >= 0) & (k12 * x2c3 + b1 >= 0)
    ok4 = (b1 >= 0) & (b2 >= 0)
    x1 = torch.where(ok1, x1c1, torch.where(ok2, x1c2, torch.where(ok3 | ok4, 0.0, a1)))
    x2 = torch.where(ok1, x2c1, torch.where(ok2, 0.0, torch.where(ok3, x2c3, torch.where(ok4, 0.0, a2))))
    d1 = torch.where(two, x1 - a1, 0.0)
    d2 = torch.where(two, x2 - a2, 0.0)
    P1, P2 = d1[:, None] * n, d2[:, None] * n
    va = va - ma * (P1 + P2)
    wa = wa - ia * (cross_vv(rA[:, 0], P1) + cross_vv(rA[:, 1], P2))
    vb = vb + mb * (P1 + P2)
    wb = wb + ib * (cross_vv(rB[:, 0], P1) + cross_vv(rB[:, 1], P2))
    ni[:, 0] = torch.where(two, x1, ni[:, 0])
    ni[:, 1] = torch.where(two, x2, ni[:, 1])
    cc.ni[sel], cc.ti[sel] = ni, ti
    _apply(vf, wf, ba, cc.dyn_a[sel], va, wa)
    _apply(vf, wf, bb, cc.dyn_b[sel], vb, wb)


def position_pass(cc, sel, cf, af, min_sep):
    """b2ContactSolver::SolvePositionConstraints over `sel`; min_sep (K,)
    takes each constraint's least separation of this pass."""
    ba, bb = cc.ba[sel], cc.bb[sel]
    ca, aa, cb, ab = cf[ba], af[ba], cf[bb], af[bb]
    ma, mb, ia, ib = cc.ma[sel, None], cc.mb[sel, None], cc.ia[sel], cc.ib[sel]
    face_a = cc.mtype[sel] == g.FACE_A
    lcA, lcB = cc.lca[sel], cc.lcb[sel]
    ms = torch.zeros_like(ia)
    for j in range(2):
        has = j < cc.pc[sel]
        pa, sa, coa = _xf(ca, aa, lcA)
        pb, sb, cob = _xf(cb, ab, lcB)
        s_ref = torch.where(face_a, sa, sb)
        c_ref = torch.where(face_a, coa, cob)
        p_ref = torch.where(face_a[:, None], pa, pb)
        s_inc = torch.where(face_a, sb, sa)
        c_inc = torch.where(face_a, cob, coa)
        p_inc = torch.where(face_a[:, None], pb, pa)
        normal = g.apply_rot(s_ref, c_ref, cc.ln[sel, None])[:, 0]
        plane = g.apply_xf(p_ref, s_ref, c_ref, cc.lp[sel, None])[:, 0]
        point = g.apply_xf(p_inc, s_inc, c_inc, cc.lps[sel, j, None])[:, 0]
        sep = g.dot(point - plane, normal) - cc.ra_shape[sel] - cc.rb_shape[sel]
        normal = torch.where(face_a[:, None], normal, -normal)
        rA, rB = point - ca, point - cb
        ms = torch.where(has, torch.minimum(ms, sep), ms)
        C = torch.clamp(BAUMGARTE * (sep + g.LINEAR_SLOP), -MAX_LINEAR_CORRECTION, 0.0)
        rna, rnb = cross_vv(rA, normal), cross_vv(rB, normal)
        K = ma[:, 0] + mb[:, 0] + ia * rna * rna + ib * rnb * rnb
        imp = torch.where(has & (K > 0), -C / torch.where(K > 0, K, 1.0), 0.0)
        P = imp[:, None] * normal
        ca, aa = ca - ma * P, aa - ia * cross_vv(rA, P)
        cb, ab = cb + mb * P, ab + ib * cross_vv(rB, P)
    min_sep[sel] = ms
    _apply(cf, af, ba, cc.dyn_a[sel], ca, aa)
    _apply(cf, af, bb, cc.dyn_b[sel], cb, ab)


def valid_order(world, color, cc, nw, nbody):
    """(W,) bool: no two constraints of one color share a dynamic body,
    and every constraint has a color."""
    bad = torch.zeros(nw, dtype=torch.bool, device=world.device)
    bad.index_fill_(0, world[color < 0], True)
    ncol = int(color.max()) + 1 if color.numel() else 0
    slots = torch.cat([torch.where(cc.dyn_a, cc.ba, -1), torch.where(cc.dyn_b, cc.bb, -1)])
    cols = torch.cat([color, color])
    keep = (slots >= 0) & (cols >= 0)
    k = slots[keep] * max(ncol, 1) + cols[keep]
    uniq, counts = torch.unique(k, return_counts=True)
    dup = uniq[counts > 1] // max(ncol, 1) // nbody
    bad.index_fill_(0, dup, True)
    return ~bad


def integrate_positions(c, a, v, w, dt, mask):
    h = dt
    trans2 = h * h * g.dot(v, v)
    ratio = torch.where(trans2 > MAX_TRANSLATION ** 2,
                        MAX_TRANSLATION / torch.sqrt(torch.where(trans2 > 0, trans2, 1.0)), 1.0)
    v = v * ratio[..., None]
    rot = h * w
    rr = torch.where(rot * rot > MAX_ROTATION ** 2,
                     MAX_ROTATION / torch.where(rot != 0, rot.abs(), 1.0), 1.0)
    w = w * rr
    c = torch.where(mask[..., None], c + h * v, c)
    a = torch.where(mask, a + h * w, a)
    return c, a, v, w


# --------------------------------------------------------------- step

def step(st: Structure, bodies: Bodies, old: Contacts, gravity, inv_dt0, dt, kw,
         order=None, prefer=None, band=0.0) -> StepOut:
    """One b2World::Step of the batch (without the TOI phase). `order`:
    a function (world, fa, fb) -> color (-1 where it has none), or None;
    `prefer` and `band` as for `collide`."""
    nw, nb = bodies.a.shape
    nf = st.fix_body.numel()
    dev, dtype = bodies.a.device, bodies.a.dtype
    dt = float(np.float32(dt))
    p, s, co = transforms(st, bodies.c, bodies.a)
    world, fa, fb, man = collide(st, p, s, co, prefer=prefer, band=band)
    touching = man.count > 0
    ni_old, ti_old, was = match_old(world, fa, fb, man, old, nf)
    margin = torch.full((nw,), g.BIG, dtype=dtype, device=dev)
    margin.scatter_reduce_(0, world, man.margin, "amin")

    # touch changes wake both bodies (b2Contact::Update)
    ba, bb = st.fix_body[fa], st.fix_body[fb]
    changed = touching != was
    awake0 = bodies.awake.clone().reshape(-1)
    awake0[(world * nb + ba)[changed]] = True
    awake0[(world * nb + bb)[changed]] = True
    non_static = (st.body_type != g.STATIC)[None].expand(nw, -1).reshape(-1)
    dynamic = (st.body_type == g.DYNAMIC)[None].expand(nw, -1).reshape(-1)
    awake0 &= non_static

    # islands over the touching contacts between non-static bodies
    fa_ns, fb_ns = non_static[world * nb + ba], non_static[world * nb + bb]
    link = touching & fa_ns & fb_ns
    lab = components(nw * nb, (world * nb + ba)[link], (world * nb + bb)[link])
    island_awake = torch.zeros(nw * nb, dtype=torch.int8, device=dev)
    island_awake.scatter_reduce_(0, lab, awake0.to(torch.int8), "amax")
    awake = (island_awake[lab] > 0) & non_static
    woken = awake & ~bodies.awake.reshape(-1)
    sleep_time = bodies.sleep_time.reshape(-1).clone()
    sleep_time[woken] = 0.0

    # velocities of the solved bodies
    h = dt
    vf = bodies.v.reshape(-1, 2).clone()
    wf = bodies.w.reshape(-1).clone()
    moving = awake & dynamic
    gv = gravity[:, None, :].expand(nw, nb, 2).reshape(-1, 2)
    vf = torch.where(moving[:, None], vf + h * gv, vf)

    # the solved contacts: touching, with an awake dynamic body
    solved = touching & ((dynamic[world * nb + ba] & awake[world * nb + ba])
                         | (dynamic[world * nb + bb] & awake[world * nb + bb]))
    k = torch.nonzero(solved, as_tuple=True)[0]
    dt_ratio = inv_dt0 * dt
    cc = prepare(st, world[k], fa[k], fb[k], _sub(man, k), ni_old[k], ti_old[k],
                 bodies.c, bodies.a, vf.reshape(nw, nb, 2), wf.reshape(nw, nb), dt_ratio,
                 kw["warm_starting"])
    kworld = world[k]
    color = order(kworld, fa[k], fb[k]) if order is not None else None
    fallback = torch.ones(nw, dtype=torch.bool, device=dev) if color is None else \
        ~valid_order(kworld, color, cc, nw, nb)
    if bool(fallback.any()):
        own = greedy_colors(kworld, cc.ba, cc.bb, cc.dyn_a, cc.dyn_b, nw, nb, dev)
        color = own if color is None else torch.where(fallback[kworld], own, color)
    ncolor = int(color.max()) + 1 if color.numel() else 0
    groups = [torch.nonzero(color == col, as_tuple=True)[0] for col in range(ncolor)]
    groups = [x for x in groups if x.numel()]
    if kw["warm_starting"]:
        warm_start(cc, vf, wf)
    for _ in range(kw["velocity_iterations"]):
        for sel in groups:
            velocity_pass(cc, sel, vf, wf)
    cf, af, vf2, wf2 = integrate_positions(bodies.c.reshape(-1, 2), bodies.a.reshape(-1),
                                           vf, wf, h, moving)
    vf, wf = vf2.clone(), wf2.clone()
    cf, af = cf.clone(), af.clone()
    min_sep = torch.zeros(k.numel(), dtype=dtype, device=dev)
    for _ in range(kw["position_iterations"]):
        for sel in groups:
            position_pass(cc, sel, cf, af, min_sep)

    # impulses stored on the touching pairs (solved ones from the solver)
    ni_new, ti_new = ni_old.clone(), ti_old.clone()
    ni_new[k], ti_new[k] = cc.ni, cc.ti
    new_contacts = sort_contacts(Contacts(world, fa, fb, man.ids, man.count, ni_new, ti_new)
                                 .select(touching), nf)

    # sleep (b2Island::Solve), island by island
    island_ok = torch.ones(nw * nb, dtype=torch.bool, device=dev)
    lab_c = lab[torch.where(non_static[cc.ba], cc.ba, cc.bb)]
    island_ok.index_fill_(0, lab_c[min_sep < -3.0 * g.LINEAR_SLOP], False)
    awake_out = awake.clone()
    sleep_edge = torch.zeros(nw, dtype=torch.bool, device=dev)
    if kw["allow_sleep"]:
        lin2, ang2 = LINEAR_SLEEP_TOL ** 2, ANGULAR_SLEEP_TOL ** 2
        v2, w2 = g.dot(vf, vf), wf * wf
        still = (w2 <= ang2) & (v2 <= lin2)
        h32 = np.float32(h)
        prev = sleep_time.float()
        new_time = torch.where(still, prev + h32, torch.zeros_like(prev))
        sleep_time = torch.where(awake, new_time.to(sleep_time.dtype), sleep_time)
        inf = float("inf")
        imin = torch.full((nw * nb,), inf, dtype=sleep_time.dtype, device=dev)
        imin.scatter_reduce_(0, lab, torch.where(awake, sleep_time, inf), "amin")
        sleeps = awake & (imin >= TIME_TO_SLEEP)[lab] & island_ok[lab]
        # where the island could be due, a body near a sleep tolerance or
        # a contact near the 3-slop rule may decide the other way in float32
        could = torch.full((nw * nb,), inf, dtype=sleep_time.dtype, device=dev)
        could.scatter_reduce_(0, lab, torch.where(awake, (prev + h32).to(sleep_time.dtype), inf),
                              "amin")
        due = awake & (could >= TIME_TO_SLEEP)[lab]
        near = torch.minimum((v2 - lin2).abs() / lin2, (w2 - ang2).abs() / ang2) < SLEEP_REL_BAND
        bw = torch.arange(nw, device=dev).repeat_interleave(nb)
        sleep_edge.index_fill_(0, bw[due & near], True)
        if k.numel():
            tight = due[cc.ba] | due[cc.bb]
            edge_c = tight & ((min_sep + 3.0 * g.LINEAR_SLOP).abs() < SLEEP_SEP_BAND)
            sleep_edge.index_fill_(0, kworld[edge_c], True)
        vf = torch.where(sleeps[:, None], 0.0, vf)
        wf = torch.where(sleeps, 0.0, wf)
        sleep_time = torch.where(sleeps, 0.0, sleep_time)
        awake_out = awake & ~sleeps
    out = Bodies(cf.reshape(nw, nb, 2), af.reshape(nw, nb), vf.reshape(nw, nb, 2),
                 wf.reshape(nw, nb), awake_out.reshape(nw, nb), sleep_time.reshape(nw, nb))
    toi = toi_watch(st, bodies, out) if kw["continuous"] else \
        torch.zeros((nw, nb), dtype=torch.bool, device=dev)
    return StepOut(out, new_contacts, margin, sleep_edge, toi, fallback)


def _sub(man, k):
    return g.Manifold(man.mtype[k], man.local_normal[k], man.local_point[k], man.points[k],
                      man.ids[k], man.count[k], man.margin[k])


def core_distance(st: Structure, c, a):
    """(W, S) distance of each watched dynamic body's core polygon to its
    static edge, at poses c (W, N, 2), a (W, N)."""
    nw = c.shape[0]
    p, s, co = transforms(st, c, a)
    bw, fw = st.watch_body, st.watch_fix
    if not bw.numel():
        return torch.zeros((nw, 0), dtype=c.dtype, device=c.device)
    fix_of = torch.full((st.body_type.numel(),), -1, dtype=torch.long, device=c.device)
    fix_of.index_copy_(0, st.fix_body.flip(0), torch.arange(st.fix_body.numel(), device=c.device).flip(0))
    fpoly = fix_of[bw]
    verts = g.apply_xf(p[:, bw], s[:, bw], co[:, bw], st.verts[fpoly][None].expand(nw, -1, -1, -1))
    sb = st.fix_body[fw]
    e = g.apply_xf(p[:, sb], s[:, sb], co[:, sb], st.verts[fw, :2][None].expand(nw, -1, -1, -1))
    d = g.polygon_segment_distance(verts.reshape(-1, verts.shape[2], 2),
                                   st.count[fpoly][None].expand(nw, -1).reshape(-1),
                                   e[:, :, 0].reshape(-1, 2), e[:, :, 1].reshape(-1, 2))
    return d.reshape(nw, -1)


def toi_watch(st: Structure, before: Bodies, after: Bodies):
    """(W, N) bool: awake dynamic bodies whose core comes within
    TOI_WATCH of a static edge at the step's start or at the end of its
    discrete part: b2World::SolveTOI may move them (its target is the
    slop, within a quarter slop), and the reference does not step it."""
    nw, nb = before.a.shape
    d = torch.minimum(core_distance(st, before.c, before.a), core_distance(st, after.c, after.a))
    near = d < TOI_WATCH
    out = torch.zeros((nw, nb), dtype=torch.int8, device=d.device)
    if near.numel():
        out.scatter_reduce_(1, st.watch_body[None].expand(nw, -1), near.to(torch.int8), "amax")
    return (out > 0) & after.awake
