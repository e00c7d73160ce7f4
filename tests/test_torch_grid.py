"""The port's grid pair finder and large-world scenes against the JAX package.

  * grid parity: `find_pairs_grid` of the port equals the JAX package's
    jitted, vmapped `find_pairs_grid` bit for bit (f_a, f_b, overflow) on
    zoo scenes, on 60-box piles from a numpy seed (one packed densely
    enough that two covered cells share a hash bucket, one with two slots
    a bucket so that entries drop), on a world with more large fixtures
    than `large_cap` (equal extents, so the choice among them follows
    jax.lax.top_k's ties), and on those worlds as one batch. Where nothing
    overflows, it also equals the port's all-pairs finder;
  * dispatch and step: a pyramid frozen at 2048 fixture slots takes the
    grid in both packages and steps past the first contacts at the
    whole-step tolerances of tests/test_pallas_solve.py (c, a to 2e-5; v
    to 1e-4), with equal pair tables;
  * scenes: tiles, multithread_demo, many_bodies (the grid inside
    `freeze`) and the six ManyBodies variants equal their JAX-built
    states leaf for leaf; `floater_drive` equals the JAX package's to the
    bit. The full-size scenes roll on the card only (chip_smoke.py).
"""

import dataclasses

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
from box2d_mt_tpu_torch import world as tworld
from box2d_mt_tpu_torch.models import scenes as tscenes
from box2d_mt_tpu_torch.ops import broadphase as tbp
from box2d_mt_tpu_torch.state import concat_worlds, state_from_numpy, to_numpy

DT = 1.0 / 60.0
# the batch's shared capacities (the piles hold 61 fixtures, the large
# world 61)
CAPS = dict(body_capacity=64, fixture_capacity=64, contact_capacity=256)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """These tensors are a few worlds wide: PyTorch's intra-op threads cost
    more than they give, and workers running side by side share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pile(seed, half_width):
    """A ground edge and 60 unit boxes at numpy-seeded positions over
    [-half_width, half_width] x [0.5, 2 half_width], at random angles."""
    rng = np.random.default_rng(seed)
    wb = jworld.WorldBuilder(gravity=(0.0, -10.0))
    ground = wb.create_body()
    wb.create_fixture(ground, jshapes.Edge((-40.0, 0.0), (40.0, 0.0)))
    for x, y, a in zip(rng.uniform(-half_width, half_width, 60),
                       rng.uniform(0.5, 2.0 * half_width, 60),
                       rng.uniform(0.0, 3.0, 60)):
        b = wb.create_body(body_type=jsettings.DYNAMIC_BODY,
                           position=(float(x), float(y)), angle=float(a))
        wb.create_fixture(b, jshapes.Polygon.box(0.5, 0.5), density=1.0)
    return wb.freeze(**CAPS)


def _many_large():
    """20 equal static 6 x 6 boxes (above the cell of a world whose median
    is a unit box) among 40 small ones: four large fixtures are dropped,
    and which four follows the tie rule."""
    wb = jworld.WorldBuilder(gravity=(0.0, -10.0))
    ground = wb.create_body()
    for k in range(20):
        wb.create_fixture(ground, jshapes.Polygon.box(3.0, 3.0, (7.0 * k - 70.0, -3.0), 0.0))
    for k in range(40):
        b = wb.create_body(body_type=jsettings.DYNAMIC_BODY,
                           position=(3.6 * k - 70.0, 0.4 + 0.1 * (k % 3)))
        wb.create_fixture(b, jshapes.Polygon.box(0.5, 0.5), density=1.0)
    return wb.freeze(**CAPS)


_WORLDS = {
    "pyramid5": lambda: jscenes.pyramid(5),
    "vertical_stack5": lambda: jscenes.vertical_stack(5),
    "gear_train": jscenes.gear_train,
    "pile_seed0": lambda: _pile(0, 12.0),
    "pile_seed1": lambda: _pile(1, 12.0),
    "pile_dense": lambda: _pile(2, 4.0),
    "many_large": _many_large,
}


@pytest.fixture(scope="module")
def grid_fn():
    """The JAX package's finder, jitted and vmapped over worlds, as numpy."""
    fns = {}

    def run(host, capacity, cell_slots):
        key = (capacity, cell_slots)
        if key not in fns:
            fns[key] = jax.jit(jax.vmap(
                lambda s: jbp.find_pairs_grid(s, capacity, cell_slots=cell_slots)))
        return [np.asarray(x) for x in fns[key](jax.tree.map(jnp.asarray, host))]
    return run


def _batched(*jstates):
    return jax.tree.map(lambda *x: np.stack([np.asarray(v) for v in x]), *jstates)


def _bucket_sharing(host, w=0):
    """Whether two distinct cells that small fixtures cover hash to one
    bucket in world `w` (numpy, the JAX package's mechanics)."""
    fx = host.fixtures
    lo, hi, ex = fx.aabb_lo[w], fx.aabb_hi[w], fx.exists[w]
    extent = np.where(ex, np.maximum(*(hi - lo).T), np.inf)
    cell = max(np.float32(1.5) * np.sort(extent)[max(ex.sum(), 1) // 2],
               np.float32(10 * jsettings.LINEAR_SLOP))
    small = ex & (extent <= cell)
    c0 = np.floor(lo[small] / cell).astype(np.int64)
    c1 = np.floor(hi[small] / cell).astype(np.int64)
    cells = {(x, y) for a, b in zip(c0, c1) for x in {a[0], b[0]} for y in {a[1], b[1]}}
    nf = fx.body.shape[1]
    nbk = max(16, 1 << (2 * nf - 1).bit_length())
    bkt = [((x * -1918851261) ^ (y * -669632447)) & (nbk - 1) for x, y in cells]
    return len(set(bkt)) < len(bkt)


def _check(host, grid_fn, cell_slots=32):
    cap = host.contacts.f_a.shape[1]
    ja, jb, jo = grid_fn(host, cap, cell_slots)
    st = state_from_numpy(host, device="cpu")
    ta, tb, to = tbp.find_pairs_grid(st, cap, cell_slots=cell_slots)
    np.testing.assert_array_equal(ta.numpy(), ja)
    np.testing.assert_array_equal(tb.numpy(), jb)
    np.testing.assert_array_equal(to.numpy(), jo)
    aa, ab, ao = tbp.find_pairs_allpairs(st, cap)
    clean = (jo == 0) & (ao.numpy() == 0)
    np.testing.assert_array_equal(ta.numpy()[clean], aa.numpy()[clean])
    np.testing.assert_array_equal(tb.numpy()[clean], ab.numpy()[clean])
    return jo, (ja >= 0).sum(1), clean


@pytest.mark.parametrize("name", list(_WORLDS))
def test_grid_matches_jax(name, grid_fn):
    host = _batched(_WORLDS[name]())
    overflow, n_pairs, clean = _check(host, grid_fn)
    if name == "many_large":
        assert overflow[0] == 4                        # 20 large, 16 kept
    else:
        assert overflow[0] == 0 and clean.all()
    if name.startswith("pile") or name.startswith("pyramid"):
        assert n_pairs[0] > 0
    if name == "pile_dense":
        assert _bucket_sharing(host)


def test_grid_bucket_overflow_matches_jax(grid_fn):
    """Two slots a bucket: entries drop, the overflow counts them, and the
    pairs kept are unique and a subset of the all-pairs pairs."""
    host = _batched(_pile(2, 4.0))
    overflow, n_pairs, _ = _check(host, grid_fn, cell_slots=2)
    assert overflow[0] > 0 and n_pairs[0] > 0
    st = state_from_numpy(host, device="cpu")
    cap = host.contacts.f_a.shape[1]
    ga, gb, _ = tbp.find_pairs_grid(st, cap, cell_slots=2)
    aa, ab, _ = tbp.find_pairs_allpairs(st, cap)
    got = {(a, b) for a, b in zip(ga[0].tolist(), gb[0].tolist()) if a >= 0}
    assert len(got) == int((ga[0] >= 0).sum())
    assert got <= {(a, b) for a, b in zip(aa[0].tolist(), ab[0].tolist()) if a >= 0}


@pytest.mark.parametrize("cell_slots", [32, 2])
def test_grid_batch_of_worlds_matches_jax(cell_slots, grid_fn):
    """Different worlds in one batch: no world's buckets see another's
    fixtures, and each world's table equals its own alone."""
    jstates = [_pile(0, 12.0), _pile(2, 4.0), _many_large()]
    host = _batched(*jstates)
    overflow, _, _ = _check(host, grid_fn, cell_slots)
    st = concat_worlds([state_from_numpy(_batched(j), device="cpu") for j in jstates])
    cap = host.contacts.f_a.shape[1]
    both = tbp.find_pairs_grid(st, cap, cell_slots=cell_slots)
    for w, j in enumerate(jstates):
        alone = tbp.find_pairs_grid(state_from_numpy(_batched(j), device="cpu"), cap,
                                    cell_slots=cell_slots)
        for x, y in zip(both, alone):
            assert torch.equal(x[w], y[0])
    assert overflow[2] == 4 and (overflow[1] > 0) == (cell_slots == 2)


def test_dispatch_takes_grid_and_steps_like_jax(monkeypatch):
    """pyramid(4) at 2048 fixture slots: `find_pairs` takes the grid in both
    packages (the all-pairs finder is not called), and the step follows
    the JAX package's past the first contacts."""
    caps = dict(body_capacity=16, fixture_capacity=2048, contact_capacity=64)

    def refuse(*args):
        raise AssertionError("the all-pairs finder ran")

    for mod in (tbp, jbp):
        monkeypatch.setattr(mod, "find_pairs_allpairs", refuse)
    jst = _pyramid4(jworld, jshapes, jsettings).freeze(**caps)
    tst = _pyramid4(tworld, tscenes.shapes, jsettings).freeze(device="cpu", **caps)
    jn = jax.tree.map(lambda x: np.asarray(x)[None], jst)
    for grp in ("bodies", "fixtures", "contacts"):
        for f in dataclasses.fields(getattr(jn, grp)):
            assert np.array_equal(getattr(getattr(to_numpy(tst), grp), f.name),
                                  getattr(getattr(jn, grp), f.name)), f"{grp}.{f.name}"
    jb = jax.tree.map(jnp.asarray, jn)
    kinds = jworld.possible_kinds(jst)
    step = jax.jit(lambda s: jworld.step_batched(s, jnp.float32(DT), kinds=kinds,
                                                 continuous=False)[0])
    touched = 0
    for i in range(34):
        jb = step(jb)
        tst, ev = tworld.step_batched(tst, DT, kinds=kinds, continuous=False)
        j, t = jax.tree.map(np.asarray, jb), to_numpy(tst)
        np.testing.assert_allclose(t.bodies.c, j.bodies.c, rtol=0, atol=2e-5, err_msg=f"c @{i}")
        np.testing.assert_allclose(t.bodies.a, j.bodies.a, rtol=0, atol=2e-5, err_msg=f"a @{i}")
        np.testing.assert_allclose(t.bodies.v, j.bodies.v, rtol=0, atol=1e-4, err_msg=f"v @{i}")
        np.testing.assert_array_equal(t.contacts.f_a, j.contacts.f_a, err_msg=f"f_a @{i}")
        np.testing.assert_array_equal(t.contacts.f_b, j.contacts.f_b, err_msg=f"f_b @{i}")
        assert int(ev.pair_overflow.max()) == 0
        touched = max(touched, int(t.contacts.touching.sum()))
    assert touched >= 8


def test_dispatch_slots_keep_every_pair_of_a_crowded_world():
    """multithread_demo(2800) at build: the JAX package's grid drops bucket
    entries and pairs (its hash's low bits crowd the pile's cells into a
    few buckets); spread over the buckets by the high bits, no bucket
    fills even 32 slots, and `find_pairs`'s table is the all-pairs table."""
    st = tscenes.multithread_demo(2800, device="cpu")
    nc = st.contacts.capacity
    fa, fb, overflow = tbp.find_pairs_grid(st, nc)
    _, _, spread_overflow = tbp.find_pairs_grid(st, nc, spread=True)
    ga, gb, g_overflow = tbp.find_pairs(st, nc)
    aa, ab, a_overflow = tbp.find_pairs_allpairs(st, nc)
    assert int(overflow) > 0 and int((fa >= 0).sum()) < int((aa >= 0).sum())
    assert int(spread_overflow) == 0
    assert int(g_overflow) == 0 and int(a_overflow) == 0
    assert torch.equal(ga, aa) and torch.equal(gb, ab)
    assert torch.equal(st.contacts.f_a, aa.to(torch.int32))


def _pyramid4(world, shapes, settings):
    wb = world.WorldBuilder(gravity=(0.0, -10.0))
    ground = wb.create_body()
    wb.create_fixture(ground, shapes.Edge((-40.0, 0.0), (40.0, 0.0)))
    x = (-7.0, 0.75)
    for i in range(4):
        y = x
        for _ in range(i, 4):
            b = wb.create_body(body_type=settings.DYNAMIC_BODY, position=y)
            wb.create_fixture(b, shapes.Polygon.box(0.5, 0.5), density=5.0)
            y = (y[0] + 1.125, y[1])
        x = (x[0] + 0.5625, x[1] + 1.25)
    return wb


def _equal_states(tn, jn):
    """Every leaf equal, but the fat AABBs of rotated bodies to 4 ulp, as
    tests/test_torch_state.py holds them: torch's and XLA's sin and cos
    may differ in the last bit."""
    for grp in ("bodies", "fixtures", "contacts", "cache"):
        for f in dataclasses.fields(getattr(tn, grp)):
            got, ref = getattr(getattr(tn, grp), f.name), getattr(getattr(jn, grp), f.name)
            assert got.dtype == ref.dtype and got[0].shape == ref.shape, f"{grp}.{f.name}"
            if f.name in ("aabb_lo", "aabb_hi"):
                with np.errstate(invalid="ignore"):
                    near = np.abs(got[0] - ref) <= 4 * np.spacing(np.abs(ref))
                assert np.all((got[0] == ref) | near), f"{grp}.{f.name}"
            else:
                assert np.array_equal(got[0], ref), f"{grp}.{f.name}"


@pytest.mark.parametrize("scene,args", [
    ("tiles", (4, 20, 2)), ("multithread_demo", (200,)), ("many_bodies", (1200,))])
def test_port_scene_equals_jax_scene(scene, args):
    """Leaf for leaf, the initial pair table too (many_bodies(1200) holds
    2048 fixture slots, so `freeze` runs the grid in both packages)."""
    tn = to_numpy(getattr(tscenes, scene)(*args, device="cpu"))
    _equal_states(tn, jax.tree.map(np.asarray, getattr(jscenes, scene)(*args)))
    if scene == "many_bodies":
        assert tn.fixtures.body.shape[1] > tbp.GRID_THRESHOLD


@pytest.mark.parametrize("k", range(1, 7))
def test_many_bodies_variant_equals_jax(k):
    tst, taux = tscenes.many_bodies_variant(k, device="cpu")
    jst, jaux = jscenes.many_bodies_variant(k)
    _equal_states(to_numpy(tst), jax.tree.map(np.asarray, jst))
    for name in ("target_speed", "floater"):
        assert taux[name].device == tst.bodies.v.device
        np.testing.assert_array_equal(taux[name][0].numpy(), np.asarray(jaux[name]))


def test_floater_drive_matches_jax():
    """On a variant's state with numpy-seeded velocities and a few bodies
    asleep, both packages' drive gives the same velocities to the bit.
    The JAX function runs op by op: jitted, XLA's CPU code contracts
    v + acc * n into one fused multiply-add (1 ulp apart on a few bodies),
    which neither package's eager operations do."""
    jst, jaux = jscenes.many_bodies_variant(2)
    rng = np.random.default_rng(5)
    nb = jst.bodies.capacity
    v = rng.normal(0.0, 30.0, (nb, 2)).astype(np.float32)
    v[3] = 0.0                                         # a body at rest
    awake = np.asarray(jst.bodies.awake).copy()
    awake[5:9] = False
    jst = dataclasses.replace(jst, bodies=dataclasses.replace(
        jst.bodies, v=jnp.asarray(v), awake=jnp.asarray(awake)))
    want = np.asarray(jscenes.floater_drive(jst, jaux, DT).bodies.v)
    tst = state_from_numpy(jax.tree.map(lambda x: np.asarray(x)[None], jst), device="cpu")
    taux = {k: torch.from_numpy(np.array(x)[None]) for k, x in jaux.items()}
    got = tscenes.floater_drive(tst, taux, DT).bodies.v[0].numpy()
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(want, v)
