"""The plain reference (Box2D 2.3.1's semantics, written anew) against the
port's CPU path on a tiny pyramid batch rolled past first contact (step
~13), the first TOI rounds and the landing of every row: followed step by
step, its manifolds, its build, and its own roll."""

import math

import torch

from benchmark import check, cells, harness
from benchmark.program import Program
from benchmark.reference import geometry as g
from benchmark.reference import world as rw
from benchmark.reference.step import DECISION_BAND, Reference, observe
from benchmark.tests import bench_tiny

SCENE = cells.scene("pyramid")
STEPS = 40


def _setup(rows=6, variants=3):
    cfg = bench_tiny.config(rows)
    off = harness.draw_offsets(bench_tiny.cell(variants=variants), cfg, SCENE, "cpu",
                               layout_seed=2**31 + 99)
    return cfg, off, dict(cfg["step"])


def _roll(prog, pool, kw, steps=STEPS):
    states, events = [pool], []
    for _ in range(steps):
        s, ev = prog.step(states[-1], kw)
        states.append(s)
        events.append(ev)
    return states, events


def test_reference_follows_the_port_step_by_step():
    cfg, off, kw = _setup()
    prog, ref = Program("cpu"), Reference("cpu")
    pool = prog.build_pool(SCENE, cfg, off)
    ref.build_pool(SCENE, cfg, off)
    states, events = _roll(prog, pool, kw)
    out, seen = ref.follow(states, events, kw)
    assert int(states[-1].contacts.touching.sum()) > 0
    assert out["position_gap_m"] < 1e-4 and out["velocity_gap_mps"] < 1e-3
    assert out["impulse_gap_Ns"] < 1e-3 and out["awake_mismatches"] == 0
    assert seen["checked"] >= 0.9 * seen["world_steps"] and seen["order_fallback"] == 0


def test_manifolds_match_the_ports_by_pair_and_feature_key():
    """The reference's collide of each state before a step against the
    manifolds the port stored in that step, where the reference's
    decisions lie clear of their thresholds."""
    cfg, off, kw = _setup()
    prog, ref = Program("cpu"), Reference("cpu")
    ref.build_pool(SCENE, cfg, off)
    st = ref.structure
    nf = st.fix_body.numel()
    states, _ = _roll(prog, prog.build_pool(SCENE, cfg, off), kw)
    compared = 0
    for pre, post in zip(states[:-1], states[1:]):
        o, po = observe(pre, st), observe(post, st)
        p, s, c = rw.transforms(st, o.bodies.c, o.bodies.a)
        world, fa, fb, man = rw.collide(st, p, s, c)
        clear = (man.margin >= DECISION_BAND) & (man.count > 0)
        mine = rw.Contacts(world, fa, fb, man.ids, man.count, man.count * 0.0, man.count * 0.0)
        keys, pkeys = mine.keys(nf)[clear], po.contacts.keys(nf)
        pos = torch.searchsorted(pkeys, keys).clamp_max(pkeys.numel() - 1)
        assert torch.equal(pkeys[pos], keys)
        assert torch.equal(po.contacts.count[pos], man.count[clear])
        assert torch.equal(po.contacts.ids[pos], man.ids[clear])
        compared += int(clear.sum())
    assert compared > 100


def test_feature_keys_of_a_box_on_the_ground():
    """Box2D 2.3.1's key: indexA | indexB << 8 | typeA << 16 | typeB << 24;
    a level box resting on an edge: the edge's face (A), the box's lower
    vertices 0 and 1 (b2EPCollider, edge axis)."""
    dt = torch.float64
    e = {"v1": torch.tensor([[-40.0, 0.0]], dtype=dt), "v2": torch.tensor([[40.0, 0.0]], dtype=dt)}
    box = g.box(0.5, 0.5)
    b = {"verts": torch.tensor([box["verts"]], dtype=dt),
         "normals": torch.tensor([box["normals"]], dtype=dt),
         "count": torch.tensor([4]), "centroid": torch.zeros((1, 2), dtype=dt)}
    zero, one = torch.zeros(1, dtype=dt), torch.ones(1, dtype=dt)
    m = g.collide_edge_polygon(e, torch.zeros((1, 2), dtype=dt), zero, one, b,
                               torch.tensor([[0.0, 0.515]], dtype=dt), zero, one)
    assert int(m.count[0]) == 2 and int(m.mtype[0]) == g.FACE_A
    assert sorted(m.ids[0].tolist()) == [g.key(0, 0, g.E_FACE, g.E_VERTEX),
                                         g.key(0, 1, g.E_FACE, g.E_VERTEX)]


def test_reference_builds_what_the_port_builds():
    cfg, off, _ = _setup()
    prog_pool = Program("cpu").build_pool(SCENE, cfg, off)
    ref_pool = Reference("cpu").build_pool(SCENE, cfg, off)
    assert check.start_gap(prog_pool, ref_pool) < 1e-6
    mass, _, inertia = g.polygon_mass(g.box(0.5, 0.5)["verts"], 5.0)
    assert math.isclose(mass, 5.0) and math.isclose(inertia, 5.0 * 2.0 / 12.0)


def test_reference_rolls_on_its_own_as_the_port_does():
    cfg, off, kw = _setup()
    prog, ref = Program("cpu"), Reference("cpu")
    p = prog.build_pool(SCENE, cfg, off)
    r = ref.build_pool(SCENE, cfg, off)
    for _ in range(STEPS):
        p, _ = prog.step(p, kw)
        r, _ = ref.step(r, kw)
    nb = ref.structure.body_type.numel()
    # no TOI phase in the reference: the two rolls part by the sub-steps' mm
    assert float((p.bodies.c[:, :nb].double() - r.bodies.c).abs().max()) < 0.05
    live = ref.structure.body_type == g.DYNAMIC
    assert float(r.bodies.c[:, live, 1].min()) > 0.4        # the stacks stand


def test_the_step_leaves_its_input_untouched():
    """The harness keeps the states of a step by reference."""
    cfg, off, kw = _setup()
    prog = Program("cpu")
    s = prog.build_pool(SCENE, cfg, off)
    for _ in range(20):
        s, _ = prog.step(s, kw)
    before = []
    prog.state.map_leaves(lambda t: before.append(t.clone()) or t, s)
    prog.step(s, kw)
    after = []
    prog.state.map_leaves(lambda t: after.append(t) or t, s)
    assert all(torch.equal(a, b) for a, b in zip(before, after))
