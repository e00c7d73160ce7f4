"""The port's PreSolve and contact-filter hooks against the JAX package.

  * `pre_solve_fn` in both forms on conveyor_belt, 40 steps beside the
    JAX package's `step` (continuous collision off) at the whole-step
    tolerances of
    tests/test_pallas_solve.py:51-60 (2e-5 on c and a, 1e-4 on v and w,
    awake equal): a bool mask that disables box 4's contacts with the
    platform (it falls through onto the ground), and a dict with all four
    keys (the same mask, a belt speed on the platform's contacts, a
    friction override on box 5's and a restitution override on box 6's).
    The port's hook sees the batch, the JAX hook one world, so each
    package gets its own hook; both answer from fixture and body indices
    alone, where the two packages consult alike. The hook adds no host
    sync: the hooked roll's count equals the plain roll's;
  * the TOI consultations on one_sided_platform's actor: from below (a
    ball launched up through the platform) it passes, from above (the
    -50 m/s circle) it stops on the platform, at y = 11.005 +- 0.05;
  * `filter_fn` in the all-pairs finder, in `find_pairs_grid` and in
    `WorldBuilder.freeze`: the pair tables equal the JAX package's for
    one filter function used unchanged by both packages, and a vetoed
    box falls through the platform;
  * the conveyor_belt_240 and one_sided_platform_240 C++ goldens as one
    padded batch of two worlds under one batched hook, at the JAX bounds
    (0.35 and 0.05, tests/test_golden_interactive.py:83-108).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from box2d_mt_tpu import settings as jsettings
from box2d_mt_tpu import shapes as jshapes
from box2d_mt_tpu import world as jworld
from box2d_mt_tpu.models import scenes as jscenes
from box2d_mt_tpu.ops import broadphase as jbp
from box2d_mt_tpu_torch import settings, shapes, world
from box2d_mt_tpu_torch.models import scenes
from box2d_mt_tpu_torch.ops import broadphase as tbp
from box2d_mt_tpu_torch.state import concat_worlds, state_from_numpy

from conftest import GOLDEN
from test_torch_grid import _batched, _pile

_STEPS = 40


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _masks(view):
    """conveyor_belt: ground 0, platform 1, boxes 2-6 (fixtures alike)."""
    plat = (view.body_a == 1) | (view.body_b == 1)
    box = lambda b: (view.body_a == b) | (view.body_b == b)  # noqa: E731
    return plat, box(4), box(5), box(6)


def _bool_hook(state, view):
    plat, b4, _, _ = _masks(view)
    return ~(plat & b4)


def _dict_hook(state, view):
    plat, b4, b5, b6 = _masks(view)
    return {"enabled": ~(plat & b4), "tangent_speed": plat * 5.0,
            "friction": (plat & b5) * 1.9 - 1.0, "restitution": b6 * 1.3 - 1.0}


@pytest.mark.parametrize("hook", [_bool_hook, _dict_hook], ids=["bool", "dict"])
def test_pre_solve_matches_jax(hook):
    """Both forms, 40 steps beside the JAX package, one JAX compile each,
    with continuous collision off (the TOI consultations are held to the
    C++ traces below)."""
    jst = jscenes.conveyor_belt()
    tst = scenes.conveyor_belt(device="cpu")
    kinds = jworld.possible_kinds(jst)
    for _ in range(_STEPS):
        jst, _ = jworld.step(jst, 1 / 60, pre_solve_fn=hook, kinds=kinds, continuous=False)
        tst, _ = world.step_batched(tst, 1 / 60, pre_solve_fn=hook, continuous=False)
    jb = jax.tree.map(np.asarray, jst.bodies)
    tb = tst.bodies
    for name, tol in (("c", 2e-5), ("a", 2e-5), ("v", 1e-4), ("w", 1e-4)):
        d = np.abs(getattr(tb, name)[0].numpy() - getattr(jb, name)).max()
        assert d <= tol, (name, d)
    assert np.array_equal(tb.awake[0].numpy(), jb.awake)
    # the hook acted: box 4 fell through the platform, box 3 rests on it
    assert float(tb.c[0, 4, 1]) < 5.0 < float(tb.c[0, 3, 1])
    if hook is _dict_hook:
        c = tst.contacts
        plat = (c.f_a == 1) | (c.f_b == 1)
        assert bool((c.tangent_speed[plat & (c.f_a >= 0)] == 5.0).all())
        jc = jax.tree.map(np.asarray, jst.contacts)
        for f in ("tangent_speed", "friction_override", "restitution_override"):
            assert np.array_equal(getattr(c, f)[0].numpy(), getattr(jc, f)), f


def test_hook_adds_no_host_sync():
    """A hook that changes nothing: the same states, and the same host
    reads in every step, as without it."""
    def neutral(states, view):
        return {"enabled": torch.ones_like(view.touching),
                "tangent_speed": view.tangent_speed,
                "friction": view.friction_override,
                "restitution": view.restitution_override}

    hooked = plain = scenes.one_sided_platform(device="cpu")
    counts = []
    for _ in range(_STEPS):
        hooked, ev_h = world.step_batched(hooked, 1 / 60, pre_solve_fn=neutral)
        plain, ev_p = world.step_batched(plain, 1 / 60)
        counts.append((ev_h.host_syncs, ev_p.host_syncs))
    assert all(h == p for h, p in counts), counts
    assert torch.equal(hooked.bodies.c, plain.bodies.c)


def _one_sided(state, view):
    """OneSidedPlatform.h:PreSolve, batched: platform (body 1) contacts
    off while the actor's (body 2) center is below the platform top."""
    below = state.bodies.c[:, 2, 1] < 10.5
    plat = (view.body_a == 1) | (view.body_b == 1)
    return ~(plat & below[:, None])


def _ball_below():
    wb = world.WorldBuilder(gravity=(0.0, -10.0))
    ground = wb.create_body()
    wb.create_fixture(ground, shapes.Edge((-40.0, 0.0), (40.0, 0.0)))
    platform = wb.create_body(position=(0.0, 10.0))
    wb.create_fixture(platform, shapes.Polygon.box(3.0, 0.5))
    ball = wb.create_body(body_type=settings.DYNAMIC_BODY, position=(0.0, 5.0),
                          linear_velocity=(0.0, 14.0))
    wb.create_fixture(ball, shapes.Circle(0.5), density=1.0)
    return wb.freeze(device="cpu")


def test_toi_consultations_one_sided_platform():
    """From below the hook disables the platform until the ball is above
    it, so it passes and lands on top; from above the -50 m/s actor's TOI
    sub-step is consulted at its TOI pose, above the top, and stops it
    there (the reference's 11.005)."""
    st, top = _ball_below(), 0.0
    for _ in range(240):
        st, _ = world.step_batched(st, 1 / 60, pre_solve_fn=_one_sided)
        top = max(top, float(st.bodies.c[0, 2, 1]))
    assert top > 11.5 and abs(float(st.bodies.c[0, 2, 1]) - 11.0) < 0.05
    st = scenes.one_sided_platform(device="cpu")
    for _ in range(30):
        st, ev = world.step_batched(st, 1 / 60, pre_solve_fn=_one_sided)
    assert abs(float(st.bodies.c[0, 2, 1]) - 11.005) < 0.05
    # without the hook the platform blocks the ball from below
    st = _ball_below()
    for _ in range(120):
        st, _ = world.step_batched(st, 1 / 60)
        assert float(st.bodies.c[0, 2, 1]) < 10.2


def test_hook_output_checked():
    st = scenes.conveyor_belt(device="cpu")
    for bad in (lambda s, v: v.touching[:, :3],
                lambda s, v: v.touching.to(torch.float32),
                lambda s, v: {"tangent_speed": v.touching},
                lambda s, v: {"speed": v.tangent_speed}):
        with pytest.raises(ValueError):
            world.step_batched(st, 1 / 60, pre_solve_fn=bad)


def _veto(state, fi, fj):
    """Fixture 1 (the platform) and fixture 2 (the box) never collide:
    index comparisons only, so that both packages take it unchanged."""
    pair = ((fi == 1) & (fj == 2)) | ((fi == 2) & (fj == 1))
    return ~pair


def _every_third(state, fi, fj):
    return ((fi + fj) % 3) != 0


def _platform_world(pkg_world, pkg_shapes, pkg_settings, filter_fn=_veto, **kw):
    wb = pkg_world.WorldBuilder(gravity=(0.0, -10.0))
    ground = wb.create_body()
    wb.create_fixture(ground, pkg_shapes.Edge((-40.0, 0.0), (40.0, 0.0)))
    plat = wb.create_body(position=(0.0, 4.0))
    wb.create_fixture(plat, pkg_shapes.Polygon.box(2.0, 0.25))
    box = wb.create_body(body_type=pkg_settings.DYNAMIC_BODY, position=(0.0, 4.6))
    wb.create_fixture(box, pkg_shapes.Polygon.box(0.4, 0.4), density=1.0)
    return wb.freeze(filter_fn=filter_fn, **kw)


def test_filter_in_freeze_and_step():
    """freeze(filter_fn=) builds JAX's pair table; stepped with the filter,
    the box falls through the platform it would otherwise land on."""
    jst = _platform_world(jworld, jshapes, jsettings)
    tst = _platform_world(world, shapes, settings, device="cpu")
    for f in ("f_a", "f_b"):
        assert np.array_equal(getattr(tst.contacts, f)[0].numpy(),
                              np.asarray(getattr(jst.contacts, f)))
    # the box rests on the platform: its only pair, which the filter vetoes
    assert int((tst.contacts.f_a >= 0).sum()) == 0
    open_ = _platform_world(world, shapes, settings, filter_fn=None, device="cpu")
    assert int((open_.contacts.f_a >= 0).sum()) == 1
    for _ in range(90):
        tst, _ = world.step_batched(tst, 1 / 60, filter_fn=_veto)
    assert float(tst.bodies.c[0, 2, 1]) < 1.0


@pytest.mark.parametrize("finder", ["allpairs", "grid"])
def test_filter_in_finders(finder):
    """find_pairs_allpairs and find_pairs_grid with a filter: (f_a, f_b,
    overflow) equal to the JAX package's jitted, vmapped finders on two
    60-box piles, world by world; the filter drops pairs."""
    host = _batched(_pile(0, 12.0), _pile(1, 12.0))
    st = state_from_numpy(host, device="cpu")
    nc = st.contacts.capacity
    if finder == "allpairs":
        got = tbp.find_pairs_allpairs(st, nc, _every_third)
        unfiltered = tbp.find_pairs_allpairs(st, nc)
        ref_fn = lambda s: jbp.find_pairs_allpairs(s, nc, _every_third)  # noqa: E731
    else:
        got = tbp.find_pairs_grid(st, nc, filter_fn=_every_third)
        unfiltered = tbp.find_pairs_grid(st, nc)
        ref_fn = lambda s: jbp.find_pairs_grid(s, nc, filter_fn=_every_third)  # noqa: E731
    ref = jax.jit(jax.vmap(ref_fn))(jax.tree.map(jnp.asarray, host))
    for g, r in zip(got, ref):
        assert np.array_equal(g.numpy(), np.asarray(r))
    n, n_all = int((got[0] >= 0).sum()), int((unfiltered[0] >= 0).sum())
    assert 0 < n < n_all


def _goldens_hook(states, view):
    """One hook for the batch [conveyor_belt, one_sided_platform]: world
    0's platform moves its contacts at 5 m/s (ConveyorBelt.h:67-84),
    world 1's platform lets the actor through from below."""
    conveyor = torch.arange(states.n_worlds) == 0
    plat_f = (view.f_a == 1) | (view.f_b == 1)
    plat_b = (view.body_a == 1) | (view.body_b == 1)
    below = states.bodies.c[:, 2, 1] < 10.5
    return {"tangent_speed": (plat_f & conveyor[:, None]) * 5.0,
            "enabled": ~(plat_b & below[:, None] & ~conveyor[:, None])}


def test_hook_goldens():
    """conveyor_belt_240 and one_sided_platform_240 in one batch of two
    worlds, each against its C++ trace (bodies in reverse creation
    order) at the JAX package's bound; the belt carries every box past
    x = 4, and the actor rests on the platform."""
    names = {"conveyor_belt": 0.35, "one_sided_platform": 0.05}
    st = concat_worlds([getattr(scenes, n)(device="cpu") for n in names])
    refs = [[json.loads(line) for line in open(GOLDEN / f"{n}_240.jsonl")] for n in names]
    worst = [0.0, 0.0]
    for i in range(240):
        st, _ = world.step_batched(st, 1 / 60, pre_solve_fn=_goldens_hook)
        p, a = st.bodies.xf_p.numpy(), st.bodies.a.numpy()
        for w, ref in enumerate(refs):
            n = len(ref[i]["bodies"])
            for j, rb in enumerate(ref[i]["bodies"]):
                k = n - 1 - j
                worst[w] = max(worst[w], abs(p[w, k, 0] - rb[0]), abs(p[w, k, 1] - rb[1]),
                               abs(a[w, k] - rb[2]))
    print(f"worst errors {dict(zip(names, worst))}")
    for w, bound in enumerate(names.values()):
        assert worst[w] < bound
    assert bool((st.bodies.xf_p[0, 2:7, 0] > 4.0).all())
    assert abs(float(st.bodies.c[1, 2, 1]) - 11.005) < 0.05
