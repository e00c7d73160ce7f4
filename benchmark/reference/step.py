"""The reference side of the check, and its control.

`Reference` builds worlds with a builder of its own (Box2D 2.3.1's
b2BodyDef, b2FixtureDef and mass rules, from the same body list the scene
generator hands the program) and steps them with `world.step`. It follows
the program step by step: each step starts from the bodies of the
program's state before it, and warm-starts from the impulses that the
reference itself stored the step before (from the program's state only
at the first step it follows, and where it did not follow the step
before). From the program it also takes the order of the constraints
(the colors its step solved in) and, only where the reference's own
choice of a polygon pair's reference face lies within DECISION_BAND of
Box2D's hysteresis, the face the program chose. `follow` returns the
compared numbers of a stretch of steps.

The TOI phase is not stepped: a body near a static edge that the
program's Events show in a TOI sub-step is left out of that step's
comparison, and the next step starts from the program's state for it.

`Reference(bf16=True)` is the control: the reference put in the
program's place with every float of its state held in bfloat16 (rounded
on the way into and out of each step, and in the worlds it builds), the
precision below the configuration's float32. It orders its constraints
by its own greedy coloring and has no TOI phase."""

import dataclasses
import math
import types

import numpy as np
import torch

from . import geometry as g
from . import world as rw

# a world's step is left out where a collider's decision lay within this
# of its threshold: float32 coordinates of some 20 m carry ~2e-6 m
DECISION_BAND = 2e-5
DTYPE = torch.float64


# ---------------------------------------------------------------- builder

class _Polygon:
    @staticmethod
    def box(hx, hy):
        return g.box(float(hx), float(hy))


class _Shapes:
    Polygon = _Polygon

    @staticmethod
    def Edge(v1, v2):
        return g.edge(v1, v2)


class WorldBuilder:
    """The scene generators' builder protocol, recording a world as Box2D's
    defaults make it (b2BodyDef: static, awake; b2FixtureDef: friction
    0.2, restitution 0, density 0)."""

    def __init__(self, gravity=(0.0, -10.0)):
        self.gravity = tuple(float(x) for x in gravity)
        self.bodies, self.fixtures = [], []

    def create_body(self, body_type=g.STATIC, position=(0.0, 0.0), angle=0.0, **_):
        # b2BodyDef.position is a b2Vec2 of float32
        pos = tuple(float(np.float32(x)) for x in position)
        self.bodies.append({"type": int(body_type), "position": pos,
                            "angle": float(np.float32(angle))})
        return len(self.bodies) - 1

    def create_fixture(self, body, shape, density=0.0, friction=0.2, restitution=0.0, **_):
        self.fixtures.append({"body": int(body), "shape": shape, "density": float(density),
                              "friction": float(friction), "restitution": float(restitution)})
        return len(self.fixtures) - 1

    def freeze(self, **_):
        return self


LIB = types.SimpleNamespace(WorldBuilder=WorldBuilder, shapes=_Shapes,
                            settings=types.SimpleNamespace(DYNAMIC_BODY=g.DYNAMIC,
                                                           STATIC_BODY=g.STATIC))


def structure_of(wb: WorldBuilder, device, dtype) -> rw.Structure:
    """Masses by b2Body::ResetMassData, shapes as built, the pairs that
    may collide (b2Body::ShouldCollide: one body dynamic; A the lower
    fixture, an edge before a polygon as b2Contact::Create orders them),
    and the (dynamic body, static edge) pairs the TOI watch reads."""
    nb, nf = len(wb.bodies), len(wb.fixtures)
    mass = [0.0] * nb
    center = [[0.0, 0.0] for _ in range(nb)]
    inertia = [0.0] * nb
    for f in wb.fixtures:
        sh = f["shape"]
        if sh["type"] != g.POLYGON or f["density"] == 0.0:
            continue
        m, c, i = g.polygon_mass(sh["verts"], f["density"])
        b = f["body"]
        mass[b] += m
        center[b][0] += m * c[0]
        center[b][1] += m * c[1]
        inertia[b] += i
    inv_mass, inv_i, lc = [], [], []
    for b, body in enumerate(wb.bodies):
        if body["type"] != g.DYNAMIC:
            inv_mass.append(0.0), inv_i.append(0.0), lc.append((0.0, 0.0))
            continue
        m = mass[b] if mass[b] > 0 else 1.0
        cx, cy = center[b][0] / m, center[b][1] / m
        i = inertia[b] - m * (cx * cx + cy * cy)
        inv_mass.append(1.0 / m)
        inv_i.append(1.0 / i if i > 0 else 0.0)
        lc.append((cx, cy))
    k = max(len(f["shape"]["verts"]) for f in wb.fixtures)
    verts = torch.zeros((nf, k, 2), dtype=dtype)
    normals = torch.zeros((nf, k, 2), dtype=dtype)
    centroid = torch.zeros((nf, 2), dtype=dtype)
    for j, f in enumerate(wb.fixtures):
        sh = f["shape"]
        verts[j, :len(sh["verts"])] = torch.tensor(sh["verts"], dtype=dtype)
        if sh["normals"]:
            normals[j, :len(sh["normals"])] = torch.tensor(sh["normals"], dtype=dtype)
            centroid[j] = torch.tensor(g.polygon_centroid(sh["verts"]), dtype=dtype)
    rmax = torch.zeros(nb, dtype=dtype)
    for j, f in enumerate(wb.fixtures):
        b = f["body"]
        d = verts[j, :len(f["shape"]["verts"])] - torch.tensor(lc[b], dtype=dtype)
        rmax[b] = max(float(rmax[b]), float(torch.sqrt((d * d).sum(-1)).max()) + f["shape"]["radius"])
    types_ = [b["type"] for b in wb.bodies]
    pa, pb = [], []
    for i in range(nf):
        for j in range(i + 1, nf):
            bi, bj = wb.fixtures[i]["body"], wb.fixtures[j]["body"]
            if bi == bj or (types_[bi] != g.DYNAMIC and types_[bj] != g.DYNAMIC):
                continue
            ti, tj = wb.fixtures[i]["shape"]["type"], wb.fixtures[j]["shape"]["type"]
            pa.append(j if (ti, tj) == (g.POLYGON, g.EDGE) else i)
            pb.append(i if (ti, tj) == (g.POLYGON, g.EDGE) else j)
    watch_b, watch_f = [], []
    for j, f in enumerate(wb.fixtures):
        if f["shape"]["type"] != g.EDGE or types_[f["body"]] == g.DYNAMIC:
            continue
        for b in range(nb):
            if types_[b] == g.DYNAMIC:
                watch_b.append(b), watch_f.append(j)
    L = lambda x: torch.tensor(x, dtype=torch.long, device=device)
    F = lambda x: torch.as_tensor(x, dtype=dtype).to(device)
    return rw.Structure(
        body_type=L(types_), inv_mass=F(inv_mass), inv_inertia=F(inv_i), local_center=F(lc),
        rmax=rmax.to(device), fix_body=L([f["body"] for f in wb.fixtures]),
        fix_type=L([f["shape"]["type"] for f in wb.fixtures]), verts=verts.to(device),
        normals=normals.to(device), count=L([len(f["shape"]["verts"]) for f in wb.fixtures]),
        radius=F([f["shape"]["radius"] for f in wb.fixtures]),
        friction=F([f["friction"] for f in wb.fixtures]),
        restitution=F([f["restitution"] for f in wb.fixtures]), centroid=centroid.to(device),
        pair_a=L(pa), pair_b=L(pb), watch_body=L(watch_b), watch_fix=L(watch_f))


# ------------------------------------------------------------------ state

@dataclasses.dataclass
class RefState:
    """A batch of the reference's worlds (the control's state)."""
    structure: rw.Structure
    bodies: rw.Bodies
    contacts: rw.Contacts
    gravity: torch.Tensor        # (W, 2)
    inv_dt0: torch.Tensor        # (W,)

    @property
    def n_worlds(self):
        return self.gravity.shape[0]


def _round_bf16(t):
    return t.to(torch.bfloat16).to(t.dtype) if t.is_floating_point() else t


def _rounded(s: RefState) -> RefState:
    b = rw.Bodies(*(_round_bf16(getattr(s.bodies, f.name)) if f.name != "sleep_time"
                    else s.bodies.sleep_time for f in dataclasses.fields(rw.Bodies)))
    c = dataclasses.replace(s.contacts, ni=_round_bf16(s.contacts.ni), ti=_round_bf16(s.contacts.ti))
    return dataclasses.replace(s, bodies=b, contacts=c)


class Observation:
    """What the reference reads of a state (the program's or its own):
    bodies (float64), the touching contacts, every pair of the table, and
    of the step that made the state: the order it solved in and the face
    type of each pair's manifold."""


def _lookup(keys, values, nf):
    """(world, fa, fb) -> the value at the pair's key, -1 where none."""
    srt, perm = torch.sort(keys)
    vals = values[perm]

    def find(world, fa, fb):
        if not srt.numel():
            return torch.full_like(world, -1)
        k = rw.pair_keys(world, fa, fb, nf)
        pos = torch.searchsorted(srt, k).clamp_max(srt.numel() - 1)
        return torch.where(srt[pos] == k, vals[pos], -1)
    return find


def observe(state, st: rw.Structure, dtype=DTYPE) -> Observation:
    o = Observation()
    nb, nf = st.body_type.numel(), st.fix_body.numel()
    if isinstance(state, RefState):
        o.bodies, o.contacts = state.bodies, state.contacts
        o.table_keys = state.contacts.keys(nf)
        o.inv_dt0, o.gravity, o.order, o.face = state.inv_dt0, state.gravity, None, None
        return o
    b, c = state.bodies, state.contacts
    f = lambda x: x[:, :nb].to(dtype)
    o.bodies = rw.Bodies(f(b.c), f(b.a), f(b.v), f(b.w), b.awake[:, :nb].clone(), f(b.sleep_time))
    exists = c.f_a >= 0
    world, slot = torch.nonzero(exists & (c.m_count > 0), as_tuple=True)
    o.contacts = rw.sort_contacts(rw.Contacts(
        world, c.f_a[world, slot].long(), c.f_b[world, slot].long(),
        c.m_ids[world, slot].long(), c.m_count[world, slot].long(),
        c.normal_impulse[world, slot].to(dtype), c.tangent_impulse[world, slot].to(dtype)), nf)
    tw, ts = torch.nonzero(exists, as_tuple=True)
    table = rw.pair_keys(tw, c.f_a[tw, ts].long(), c.f_b[tw, ts].long(), nf)
    o.table_keys = torch.sort(table).values
    o.face = _lookup(table, c.m_type[tw, ts].long(), nf)
    o.inv_dt0, o.gravity = state.inv_dt0.to(dtype), state.gravity.to(dtype)
    cache = state.cache
    cw, cs = torch.nonzero(cache.color >= 0, as_tuple=True)
    o.order = _lookup(rw.pair_keys(cw, cache.sig_f_a[cw, cs].long(), cache.sig_f_b[cw, cs].long(), nf),
                      cache.color[cw, cs].long(), nf)
    return o


def toi_moved(events, st: rw.Structure, nw):
    """(W, N) bool: bodies on a contact to which the program's Events give
    a TOI sub-step impulse (none for the reference's own steps)."""
    nb = st.body_type.numel()
    out = torch.zeros((nw, nb), dtype=torch.bool, device=st.fix_body.device)
    imp = getattr(events, "toi_normal_impulse", None)
    if imp is None:
        return out
    hit = ((imp != 0) | (events.toi_tangent_impulse != 0)).any(-1) & (events.toi_f_a >= 0)
    w, slot = torch.nonzero(hit, as_tuple=True)
    for f in (events.toi_f_a, events.toi_f_b):
        b = st.fix_body[f[w, slot].long()]
        out[w, b] = True
    return out


# -------------------------------------------------------------- reference

class Reference:
    """The reference on `device`, or (bf16) its control."""

    def __init__(self, device, bf16=False):
        self.device = torch.device(device)
        self.bf16 = bf16
        self.structure = None

    def build_pool(self, scene, config, offsets) -> RefState:
        """One world a row of `offsets` (V, n) float64, as one batch."""
        worlds = [scene.build(LIB, config, row) for row in np.asarray(offsets, np.float64)]
        st = structure_of(worlds[0], self.device, DTYPE)
        for wb in worlds[1:]:
            if [(b["type"]) for b in wb.bodies] != [b["type"] for b in worlds[0].bodies] or \
                    [(f["body"], f["shape"]["type"]) for f in wb.fixtures] != \
                    [(f["body"], f["shape"]["type"]) for f in worlds[0].fixtures]:
                raise ValueError("the worlds of a batch differ in their bodies or fixtures")
        self.structure = st
        dev, dt = self.device, DTYPE
        pos = torch.tensor([[b["position"] for b in wb.bodies] for wb in worlds], dtype=dt, device=dev)
        ang = torch.tensor([[b["angle"] for b in wb.bodies] for wb in worlds], dtype=dt, device=dev)
        s, c = torch.sin(ang), torch.cos(ang)
        lx, ly = g.rot(s, c, st.local_center[:, 0], st.local_center[:, 1])
        center = torch.stack([pos[..., 0] + lx, pos[..., 1] + ly], -1)
        nw, nb = ang.shape
        bodies = rw.Bodies(center, ang, torch.zeros_like(center), torch.zeros_like(ang),
                           torch.ones((nw, nb), dtype=torch.bool, device=dev),
                           torch.zeros_like(ang))
        grav = torch.tensor([wb.gravity for wb in worlds], dtype=dt, device=dev)
        pool = RefState(st, bodies, rw.Contacts.empty(dev, dt), grav,
                        torch.zeros(nw, dtype=dt, device=dev))
        return _rounded(pool) if self.bf16 else pool

    def gather(self, pool: RefState, idx) -> RefState:
        b = rw.Bodies(*(getattr(pool.bodies, f.name).index_select(0, idx)
                        for f in dataclasses.fields(rw.Bodies)))
        if pool.contacts.world.numel():
            raise ValueError("a pool of fresh worlds holds no contacts")
        return RefState(pool.structure, b, pool.contacts, pool.gravity.index_select(0, idx),
                        pool.inv_dt0.index_select(0, idx))

    def step(self, state: RefState, step_kw, **_hooks):
        """One step of the reference's own batch (the control's path)."""
        s = _rounded(state) if self.bf16 else state
        out = rw.step(s.structure, s.bodies, s.contacts, s.gravity, s.inv_dt0,
                      step_kw["dt"], step_kw)
        new = RefState(s.structure, out.bodies, out.contacts, s.gravity,
                       torch.full_like(s.inv_dt0, 1.0 / float(np.float32(step_kw["dt"]))))
        if self.bf16:
            new = _rounded(new)
        zw = torch.zeros(s.n_worlds, dtype=torch.int32, device=self.device)
        return new, types.SimpleNamespace(pair_overflow=zw, toi_overflow=zw,
                                          color_overflow=zw, host_syncs=0)

    # ------------------------------------------------------------ check

    def follow(self, states, events, step_kw) -> tuple:
        """The stretch `states` (s_0 ... s_n of one episode, the timed
        path's) and the `events` of its steps against the reference: each
        step from the state before it. Returns the compared numbers and
        what the check left out."""
        st = self.structure
        nf = st.fix_body.numel()
        live = st.body_type == g.DYNAMIC
        out = {"position_gap_m": 0.0, "velocity_gap_mps": 0.0, "impulse_gap_Ns": 0.0,
               "awake_mismatches": 0.0}
        seen = {"world_steps": 0, "checked": 0, "toi_bodies": 0, "order_fallback": 0,
                "least_margin": math.inf}
        memory = None
        pre = observe(states[0], st, DTYPE)
        for nxt, ev in zip(states[1:], events):
            post = observe(nxt, st, DTYPE)
            old = pre.contacts if memory is None else memory
            r = rw.step(st, pre.bodies, old, pre.gravity, pre.inv_dt0, step_kw["dt"], step_kw,
                        order=post.order, prefer=post.face, band=DECISION_BAND)
            checked = (r.margin >= DECISION_BAND) & ~r.sleep_edge
            x = r.toi_bodies & toi_moved(ev, st, checked.numel())
            seen["world_steps"] += checked.numel()
            seen["checked"] += int(checked.sum())
            seen["toi_bodies"] += int(x.sum())
            seen["order_fallback"] += int(r.order_fallback.sum())
            seen["least_margin"] = min(seen["least_margin"], float(r.margin.min()))
            keep = checked[:, None] & live[None] & ~x
            pb, rb = post.bodies, r.bodies
            rad = st.rmax[None]
            pos = (pb.c - rb.c).abs().amax(-1) + (pb.a - rb.a).abs() * rad
            vel = (pb.v - rb.v).abs().amax(-1) + (pb.w - rb.w).abs() * rad
            out["position_gap_m"] = max(out["position_gap_m"], _max(pos, keep))
            out["velocity_gap_mps"] = max(out["velocity_gap_mps"], _max(vel, keep))
            out["awake_mismatches"] += float((keep & (pb.awake != rb.awake)).sum())
            out["impulse_gap_Ns"] = max(out["impulse_gap_Ns"],
                                        self._impulse_gap(post, r, checked, x, nf))
            memory = self._memory(r, post, checked, x, nf)
            pre = post
        return out, seen

    def _impulse_gap(self, post, r, checked, x, nf):
        """Widest gap of a stored normal or tangent impulse, point by
        point, matched by (pair, feature key); a point on one side only
        is an infinite gap, but for a pair that the program's table no
        longer holds because its skins' bounds came apart."""
        st = self.structure
        nb = st.body_type.numel()

        def points(c: rw.Contacts):
            ok = checked[c.world] & ~x.reshape(-1)[c.world * nb + st.fix_body[c.fa]] \
                & ~x.reshape(-1)[c.world * nb + st.fix_body[c.fb]]
            pair = c.keys(nf)
            two = torch.arange(2, device=pair.device)
            has = (two[None] < c.count[:, None]) & ok[:, None]
            k = (pair[:, None] << 32) | c.ids
            return k[has], c.ni[has], c.ti[has], pair[:, None].expand(-1, 2)[has]

        pk, pni, pti, _ = points(post.contacts)
        rk, rni, rti, rpair = points(r.contacts)
        pk, o = torch.sort(pk)
        pni, pti = pni[o], pti[o]
        rk, o = torch.sort(rk)
        rni, rti, rpair = rni[o], rti[o], rpair[o]
        gap = 0.0
        if pk.numel():
            pos = torch.searchsorted(rk, pk).clamp_max(max(rk.numel() - 1, 0))
            found = (rk[pos] == pk) if rk.numel() else torch.zeros_like(pk, dtype=torch.bool)
            if not bool(found.all()):
                return math.inf
            gap = max(float((pni - rni[pos]).abs().max()), float((pti - rti[pos]).abs().max()))
        if rk.numel():
            pos = torch.searchsorted(pk, rk).clamp_max(max(pk.numel() - 1, 0))
            found = (pk[pos] == rk) if pk.numel() else torch.zeros_like(rk, dtype=torch.bool)
            lost = rpair[~found]
            if lost.numel():
                t = post.table_keys
                tpos = torch.searchsorted(t, lost).clamp_max(max(t.numel() - 1, 0))
                in_table = (t[tpos] == lost) if t.numel() else torch.zeros_like(lost, dtype=torch.bool)
                if bool(in_table.any()) or bool(self._bounds_meet(post.bodies, lost, nf).any()):
                    return math.inf
        return gap

    def _bounds_meet(self, bodies, pair_keys, nf):
        st = self.structure
        fb = pair_keys % nf
        fa = (pair_keys // nf) % nf
        w = pair_keys // (nf * nf)
        p, s, c = rw.transforms(st, bodies.c, bodies.a)
        lo, hi = rw.fixture_aabbs(st, p, s, c)
        return ((lo[w, fa] <= hi[w, fb]) & (lo[w, fb] <= hi[w, fa])).all(-1)

    def _memory(self, r, post, checked, x, nf):
        """The warm-start impulses for the next step: the reference's own,
        but in the worlds it left out and on the pairs of bodies the TOI
        phase may have moved, where it takes the program's state."""
        st = self.structure
        nb = st.body_type.numel()
        xf = x.reshape(-1)

        def own(c):
            return checked[c.world] & ~xf[c.world * nb + st.fix_body[c.fa]] \
                & ~xf[c.world * nb + st.fix_body[c.fb]]

        mine = r.contacts.select(own(r.contacts))
        theirs = post.contacts.select(~own(post.contacts))
        return rw.sort_contacts(rw.Contacts.cat([mine, theirs]), nf)


def _max(x, keep):
    if not bool(keep.any()):
        return 0.0
    v = x[keep]
    if not bool(v.isfinite().all()):
        return math.inf
    return float(v.max())
