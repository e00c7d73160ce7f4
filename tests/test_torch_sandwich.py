"""The sandwich (the solve middle of worlds with joints) on the CPU.

  * the four plain functions composed (pack, 8 velocity sweeps, position
    integration, 3 position sweeps, unpack) equal `solve_middle_plain` bit
    for bit on inputs captured from the port's own pyramid(6) step, with
    and without color overflow;
  * the four plain functions against the JAX package's TPU kernels
    `pack_packed` / `vel_iter_packed` / `pos_iter_packed` / `unpack_packed`
    run in interpret mode on the same small input (2 worlds), compared
    after unpack in slot order, since the packed layouts differ
    (tolerance: 1e-5 positions, 1e-4 velocities and impulses);
  * the launch shapes the host picks for the solve-middle kernel (its
    resident or ring path), for the sweep kernels (threads a world, worlds
    a block, tile, ring depth, shared memory) and for the unpack kernel,
    from the static shapes of the scenes the port runs;
  * the whole step of ONE scene that holds all four ported joint types
    and boxes landing on an edge ground, built with both packages'
    builders, 2 worlds, 40 steps with continuous collision on, against the
    JAX step on its default CPU path: c and a to 2e-5, v and w to 1e-4,
    joint impulses to 1e-4, `awake` and limit states equal.
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
from box2d_mt_tpu.ops import pallas_solve
from box2d_mt_tpu.parallel.sharding import replicate_state
from box2d_mt_tpu_torch import settings as tsettings
from box2d_mt_tpu_torch import shapes as tshapes
from box2d_mt_tpu_torch import world as tworld
from box2d_mt_tpu_torch.models import scenes as tscenes
from box2d_mt_tpu_torch.ops import solve_middle as sm
from box2d_mt_tpu_torch.ops.integrate import integrate_positions
from box2d_mt_tpu_torch.state import replicate, to_numpy

DT = 1.0 / 60.0
VI, PI = 8, 3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """These tensors are a few worlds wide: PyTorch's intra-op threads cost
    more than they give, and workers running side by side share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _captured(max_colors):
    """The solve middle's arguments at step 25 of 2 x pyramid(6)."""
    states = replicate(tscenes.pyramid(6, device="cpu"), 2)
    got = {}

    def middle(*args):
        got["args"] = args
        return sm.solve_middle(*args)

    for _ in range(25):
        states, ev = tworld.step_batched(states, DT, continuous=False,
                                         max_colors=max_colors, middle=middle)
    return got["args"], int(ev.color_overflow.min())


@pytest.fixture(scope="module", params=[16, 3], ids=["colors", "overflow"])
def captured(request):
    args, overflow = _captured(request.param)
    assert (overflow > 0) == (request.param == 3)
    assert int(args[2][:, -1].sum()) > 20        # real contacts are solved
    return args


def _compose(sandwich, blob, perm, color_start, dyn_ab, vel, pos, movable, dt, vi, pi):
    packed = sandwich.pack(blob, perm, color_start)
    for _ in range(vi):
        vel = sandwich.vel_iter(packed, perm, color_start, dyn_ab, vel)
    c, a, v, w = integrate_positions(pos[:, 0:2].transpose(1, 2), pos[:, 2],
                                     vel[:, 0:2].transpose(1, 2), vel[:, 2], dt, movable)
    vel = torch.stack([v[..., 0], v[..., 1], w], 1).contiguous()
    pos = torch.stack([c[..., 0], c[..., 1], a], 1).contiguous()
    for _ in range(pi):
        pos = sandwich.pos_iter(packed, perm, color_start, dyn_ab, pos)
    return vel, pos, sandwich.unpack(packed, perm, color_start)


@pytest.mark.parametrize("which", ["wrappers", "plain"])
def test_composed_sandwich_equals_solve_middle_plain(captured, which, monkeypatch):
    """Bit for bit: the sandwich is the solve middle cut at four seams. On
    CPU tensors the wrappers take the plain versions, and launch nothing."""
    def no_launch(name, *args, **kwargs):
        raise AssertionError(f"{name} launched on CPU tensors")

    monkeypatch.setattr(sm, "_call", no_launch)
    sandwich = sm.SANDWICH if which == "wrappers" else sm.SANDWICH_PLAIN
    ref = sm.solve_middle_plain(*captured)
    got = _compose(sandwich, *captured)
    for name, x, y in zip(("vel", "pos", "aux"), got, ref):
        assert torch.equal(x, y), name
    assert float(ref[2][:, :4].abs().max()) > 0.1


def test_sandwich_wrappers_check_arguments(captured):
    blob, perm, color_start, dyn_ab, vel, pos = captured[:6]
    packed = sm.pack_packed(blob, perm, color_start)
    assert packed.shape == (blob.shape[0], 52, blob.shape[2])
    with pytest.raises(ValueError, match="perm"):
        sm.pack_packed(blob, perm.long(), color_start)
    with pytest.raises(ValueError, match="contiguous"):
        sm.vel_iter_packed(packed, perm, color_start, dyn_ab,
                           vel.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="packed"):
        sm.pos_iter_packed(blob, perm, color_start, dyn_ab, pos)
    with pytest.raises(ValueError, match="color_start"):
        sm.unpack_packed(packed, perm, color_start[:, :1].contiguous())


def test_plain_sandwich_matches_pallas_interpret():
    """The TPU kernels pack their table in CK-padded chunks through `dest`;
    the port packs densely through `perm`. Same rows, same sweeps."""
    (blob, perm, color_start, dyn_ab, vel, pos, movable, *_), _ = _captured(16)
    nw, _, nc = blob.shape
    nb = vel.shape[-1]
    mc = color_start.shape[-1] - 1
    ck = pallas_solve.CK
    # JAX layout (world.py:570-589): each color padded to a CK multiple
    sizes = (color_start[:, 1:] - color_start[:, :-1]).numpy()
    chunks = -(-sizes // ck)
    starts = (np.cumsum(chunks, 1) - chunks) * ck
    p_total = -(-(nc + mc * ck) // ck) * ck
    dest = np.full((nw, nc), p_total, np.int32)
    cs, pm = color_start.numpy(), perm.numpy()
    for w in range(nw):
        for c in range(mc):
            slots = pm[w, cs[w, c]:cs[w, c + 1]]
            dest[w, slots] = starts[w, c] + np.arange(len(slots))
    n_chunks = jnp.int32(chunks.sum(1).max())
    pad = lambda x, rows: jnp.concatenate(
        [jnp.asarray(x.numpy()), jnp.zeros((nw, 8 - rows, nb), jnp.float32)], 1)
    jvel = pad(vel, 3)
    jpos = pad(torch.cat([pos, movable.float()[:, None]], 1), 4)

    pblob, aux = pallas_solve.pack_packed(jnp.asarray(blob.numpy()), jnp.asarray(dest),
                                          n_chunks, p_total, interpret=True)
    for _ in range(2):
        jvel, aux = pallas_solve.vel_iter_packed(pblob, aux, jvel, n_chunks, interpret=True)
    for _ in range(2):
        jpos, aux = pallas_solve.pos_iter_packed(pblob, aux, jpos, n_chunks, interpret=True)
    jaux = np.asarray(pallas_solve.unpack_packed(aux, jnp.asarray(dest), n_chunks,
                                                 interpret=True))

    packed = sm.pack_packed_plain(blob, perm, color_start)
    for _ in range(2):
        vel = sm.vel_iter_packed_plain(packed, perm, color_start, dyn_ab, vel)
    for _ in range(2):
        pos = sm.pos_iter_packed_plain(packed, perm, color_start, dyn_ab, pos)
    taux = sm.unpack_packed_plain(packed, perm, color_start).numpy()

    np.testing.assert_allclose(vel.numpy(), np.asarray(jvel)[:, :3], rtol=0, atol=1e-4)
    np.testing.assert_allclose(pos.numpy(), np.asarray(jpos)[:, :3], rtol=0, atol=1e-5)
    np.testing.assert_allclose(taux[:, :4], jaux[:, :4], rtol=0, atol=1e-4)
    slop = -3.0 * tsettings.LINEAR_SLOP
    np.testing.assert_array_equal(taux[:, 4] >= slop, jaux[:, 4] >= slop)
    assert np.abs(jaux[:, :4]).max() > 0.1 and (jaux[:, 5:] == 0).all()


@pytest.mark.parametrize("n_bodies,n_contacts,rows,want", [
    (32, 128, sm.VEL_ROWS, (32, 4, 128, 1)),       # chain_links(30)
    (64, 256, sm.VEL_ROWS, (64, 2, 256, 1)),       # pyramid(10)
    (64, 258, sm.VEL_ROWS, (64, 1, 256, 2)),       # a slot count off the tiers
    (256, 1024, sm.VEL_ROWS, (256, 1, 256, 2)),    # tumbler(200)
    (256, 1024, sm.POS_ROWS, (256, 1, 256, 2)),
    (1024, 4096, sm.VEL_ROWS, (256, 1, 256, 2)),   # pyramid(44)
    (4096, 16384, sm.VEL_ROWS, (256, 1, 256, 2)),  # multithread_demo(2800)
    (8192, 32768, sm.VEL_ROWS, (256, 1, 256, 2)),  # many_bodies(5000)
    (16384, 65536, sm.VEL_ROWS, (256, 1, 256, 2)),  # many_bodies(10000): global planes
    (16384, 65536, sm.POS_ROWS, (256, 1, 256, 2)),
], ids=["chain", "pyramid10", "c258", "tumbler_vel", "tumbler_pos", "pyramid44",
        "multithread2800", "many_bodies5000", "many_bodies10000_vel",
        "many_bodies10000_pos"])
def test_sweep_shape_from_static_shapes(n_bodies, n_contacts, rows, want):
    """What the sweep kernels require of their launch shape, and the shape
    each scene of the port gets; a world whose body plane does not fit a
    block beside the ring keeps it in global memory."""
    shape = sm.sweep_shape(n_bodies, n_contacts, 16, rows)
    tw, wpb, tile, n_buffers, smem, global_planes = shape
    assert (tw, wpb, tile, n_buffers) == want
    assert global_planes == (n_bodies > 8192)
    assert tw % 32 == 0 and 32 <= tw and tw * wpb <= sm.CK
    assert tile % 32 == 0 and tile >= min(sm.CK, n_contacts)   # a chunk fits a tile
    assert n_buffers * tile >= min(n_contacts, 2 * tile)
    world = sm._sweep_world_bytes(rows, n_bodies, n_contacts, 16, tile, n_buffers,
                                  global_planes)
    assert smem == wpb * world and world % 16 == 0
    if global_planes:
        assert sm._sweep_world_bytes(rows, n_bodies, n_contacts, 16, tile,
                                     n_buffers) > sm.SMEM_BLOCK_MAX
        assert world >= 4 * n_buffers * rows * tile
    else:
        assert world >= 4 * (n_buffers * rows * tile + 3 * n_bodies) + n_contacts
    assert smem <= sm.SMEM_BLOCK_MAX
    if wpb > 1:
        assert 2 * smem <= sm.SMEM_BLOCK_MAX       # a second block fits the SM


@pytest.mark.parametrize("n_bodies,n_contacts,want", [
    (32, 128, (64, True, 128, 1)),        # pyramid(6)
    (64, 256, (128, True, 256, 1)),       # pyramid(10)
    (64, 258, (160, True, 260, 1)),       # a slot count off the tiers
    (256, 1024, (256, True, 1024, 1)),    # pyramid(22)
    (1024, 4096, (256, False, 672, 2)),   # pyramid(44): the ring
    (4096, 16384, (256, False, 352, 2)),  # multithread_demo(2800): the ring
    (8192, 32768, (256, False, 768, 2)),  # many_bodies(5000): global planes
    (16384, 65536, (256, False, 768, 2)),  # many_bodies(10000): global planes
], ids=["c128", "c256", "c258", "c1024", "c4096", "c16384", "c32768", "c65536"])
def test_middle_shape_from_static_shapes(n_bodies, n_contacts, want):
    """K1's launch shape: a world's table stays resident in shared memory
    while a world fits a block, and goes through the ring beyond, with its
    body planes in global memory where they leave no ring tile of 32
    lanes; the shared memory a block (a world) takes is the layout sum."""
    shape = sm.middle_shape(n_bodies, n_contacts, 16)
    tw, resident, tile, n_buffers, smem, global_planes = shape
    assert (tw, resident, tile, n_buffers) == want
    assert global_planes == (n_bodies > 4096)
    assert tw % 32 == 0 and 32 <= tw <= sm.CK
    world = sm._middle_world_bytes(resident, n_bodies, n_contacts, 16, tile, n_buffers,
                                   global_planes)
    assert smem == world and world % 16 == 0 and smem <= sm.SMEM_BLOCK_MAX
    whole = sm._middle_world_bytes(True, n_bodies, n_contacts, 16, -(-n_contacts // 4) * 4, 1)
    assert resident == (whole <= sm.SMEM_BLOCK_MAX)
    if resident:
        # 37 rows of the slots, both body planes and the movable flags
        assert tile >= n_contacts and tile % 4 == 0
        assert world >= 4 * (sm.RESIDENT_ROWS * n_contacts + 6 * n_bodies) + n_bodies
    elif not global_planes:
        # the tiles of the velocity rows, which then hold perm's inverse
        assert tile % 32 == 0 and n_buffers * tile >= min(n_contacts, 2 * tile)
        assert world >= 4 * max(n_buffers * sm.VEL_ROWS * tile, n_contacts)
        wider = sm._middle_world_bytes(False, n_bodies, n_contacts, 16, tile + 32, n_buffers)
        assert wider > sm.SMEM_BLOCK_MAX             # the widest tiles that fit
    else:
        # no ring tile of 32 lanes beside the planes: the tiles alone
        assert sm._middle_world_bytes(False, n_bodies, n_contacts, 16, 32,
                                      n_buffers) > sm.SMEM_BLOCK_MAX
        assert tile % 32 == 0 and world >= 4 * n_buffers * sm.VEL_ROWS * tile
        wider = sm._middle_world_bytes(False, n_bodies, n_contacts, 16, tile + 32,
                                       n_buffers, True)
        assert wider > sm.SMEM_BLOCK_MAX
    # pyramid(10)'s world by hand: rows, chunk deltas and endpoints, two
    # body planes, movable flags, color_start, dyn flags
    assert sm._middle_world_bytes(True, 64, 256, 16, 256, 1) == (
        37 * 256 * 4 + 8 * 256 * 4 + 2 * 768 + 64 + 80 + 256)


def test_plain_apply_in_rounds_keeps_lane_order():
    """The plain versions' apply on a card (round k adds each body's k-th
    delta) sums in lane order, as scatter_add_ does on the CPU and the
    kernels do in an overflow chunk: equal to the bit."""
    g = torch.Generator().manual_seed(0)
    nw, nb, nl = 3, 20, 300
    state = torch.randn(nw, 3, nb + 1, generator=g)
    idx = torch.randint(0, nb + 1, (nw, 2 * nl), generator=g)
    delta = torch.randn(nw, 3, 2 * nl, generator=g)
    want = state.clone().scatter_add_(2, idx[:, None].expand(-1, 3, -1), delta)
    got = state.clone()
    sm._apply_in_rounds(got, idx, delta)
    assert torch.equal(got[..., :nb], want[..., :nb])


@pytest.mark.parametrize("max_colors", [3, 16])
def test_shapes_fit_every_world_size(max_colors):
    """Every world the JAX package steps, up to 65536 bodies and 262144
    contact slots, gets a launch shape of K1 and of both sweeps within a
    block's shared memory and with tiles of at least 32 lanes."""
    sizes = lambda top: sorted({1 << k for k in range(top.bit_length())}
                               | {3, 100, 1000, 3000, 5000, 50000, top} - {0})
    for n_bodies in sizes(65536):
        for n_contacts in sizes(262144):
            m = sm.middle_shape(n_bodies, n_contacts, max_colors)
            assert m.smem_bytes <= sm.SMEM_BLOCK_MAX, (n_bodies, n_contacts)
            assert m.tile >= (n_contacts if m.resident else 32), (n_bodies, n_contacts)
            assert m.resident or m.tile % 32 == 0
            for rows in (sm.VEL_ROWS, sm.POS_ROWS):
                w = sm.sweep_shape(n_bodies, n_contacts, max_colors, rows)
                assert w.smem_bytes <= sm.SMEM_BLOCK_MAX, (n_bodies, n_contacts, rows)
                assert w.tile >= 32 and w.tile % 32 == 0


def test_unpack_shape_from_static_shapes():
    """Worlds a block by slot count; a world's five rows are spread over
    blocks only while the batch leaves SMs idle."""
    got = [sm.unpack_shape(4096, c)[0] for c in (64, 128, 130, 256, 512, 1024, 4096)]
    assert got == [8, 8, 4, 4, 2, 1, 1]
    assert sm.unpack_shape(256, 1024) == (1, 2)        # 256 x tumbler(200)
    assert sm.unpack_shape(512, 128) == (8, 5)         # 512 x chain_links(30)
    assert sm.unpack_shape(16, 4096) == (1, 5)
    assert sm.unpack_shape(4096, 256) == (4, 1)


# the joint types of the mixed scene; its other blocks are empty
MIXED_TYPES = ("revolute", "distance", "prismatic", "weld")


def _mixed_scene(world, shapes, settings, **freeze_kw):
    """Four joint types over an edge ground, and loose boxes
    that land on it: a revolute chain with a motor and a limit, a
    motorized prismatic slider that runs into its limit, a rigid and a
    soft distance pendulum, a rigid weld off the ground with a soft weld
    on it, and a box welded in place."""
    dyn = settings.DYNAMIC_BODY
    wb = world.WorldBuilder(gravity=(0.0, -10.0))
    ground = wb.create_body()
    wb.create_fixture(ground, shapes.Edge((-40.0, 0.0), (40.0, 0.0)))
    plank = shapes.Polygon.box(0.6, 0.125)
    prev = ground
    for i in range(3):
        b = wb.create_body(body_type=dyn, position=(-9.5 + i, 2.5))
        wb.create_fixture(b, plank, density=4.0)
        wb.create_revolute_joint(
            prev, b, (-10.0 + i, 2.5), enable_motor=i == 0, motor_speed=1.0,
            max_motor_torque=50.0, enable_limit=i == 2, lower_angle=-0.15,
            upper_angle=0.15)
        prev = b
    slider = wb.create_body(body_type=dyn, position=(0.0, 3.0), angle=0.3)
    wb.create_fixture(slider, shapes.Polygon.box(0.5, 0.25), density=5.0)
    wb.create_prismatic_joint(
        ground, slider, (0.0, 3.0), (1.0, 0.0), enable_motor=True, motor_speed=3.0,
        max_motor_force=500.0, enable_limit=True, lower_translation=-0.5,
        upper_translation=0.4)
    for i, (freq, damp) in enumerate(((0.0, 0.0), (2.0, 0.3))):
        x = 5.0 + 3.0 * i
        b = wb.create_body(body_type=dyn, position=(x, 3.0), linear_velocity=(2.0, 0.0))
        wb.create_fixture(b, shapes.Polygon.box(0.3, 0.3), density=2.0)
        if i == 0:
            wb.create_distance_joint(ground, b, (x, 6.0), (x, 3.2))
        else:
            wb.create_joint_raw(
                "distance", body_a=ground, body_b=b, local_anchor_a=(x, 6.0),
                local_anchor_b=(0.1, 0.2), length=2.5, frequency=freq,
                damping_ratio=damp)
    beam = shapes.Polygon.box(0.5, 0.125)
    b1 = wb.create_body(body_type=dyn, position=(12.5, 3.0))
    wb.create_fixture(b1, beam, density=4.0)
    wb.create_weld_joint(ground, b1, (12.0, 3.0))
    b2 = wb.create_body(body_type=dyn, position=(13.5, 3.0))
    wb.create_fixture(b2, beam, density=4.0)
    wb.create_weld_joint(b1, b2, (13.0, 3.0), frequency=5.0, damping_ratio=0.7)
    # welded to the ground at its center: an island of one body that the
    # weld holds still, so it falls asleep after half a second
    still = wb.create_body(body_type=dyn, position=(17.0, 2.0))
    wb.create_fixture(still, shapes.Polygon.box(0.3, 0.3), density=1.0)
    wb.create_weld_joint(ground, still, (17.0, 2.0))
    for pos in ((-3.0, 0.4), (-2.0, 0.5), (-3.0, 1.0)):
        b = wb.create_body(body_type=dyn, position=pos)
        wb.create_fixture(b, shapes.Polygon.box(0.25, 0.25), density=1.0, friction=0.3)
    return wb.freeze(**freeze_kw)


@pytest.fixture(scope="module")
def mixed_run():
    """Both packages step the same two worlds (the second with velocities
    perturbed from a numpy seed) 40 times; one JAX compile."""
    jscene = _mixed_scene(jworld, jshapes, jsettings)
    tscene = _mixed_scene(tworld, tshapes, tsettings, device="cpu")
    kinds = jworld.possible_kinds(jscene)
    assert kinds == tworld.possible_kinds(tscene)
    rng = np.random.default_rng(3)
    dv = rng.uniform(-0.5, 0.5, jscene.bodies.v.shape).astype(np.float32)
    dv[np.asarray(jscene.bodies.body_type) != 2] = 0.0

    jst = replicate_state(jscene, 2)
    jst = dataclasses.replace(jst, bodies=dataclasses.replace(
        jst.bodies, v=jst.bodies.v.at[1].add(jnp.asarray(dv))))
    tst = replicate(tscene, 2)
    tv = tst.bodies.v.clone()
    tv[1] += torch.from_numpy(dv)
    tst = dataclasses.replace(tst, bodies=dataclasses.replace(tst.bodies, v=tv))

    jstep = jax.jit(lambda s: jworld.step_batched(s, jnp.float32(DT), kinds=kinds))
    jax_steps, port_steps, syncs = [], [], []
    for _ in range(40):
        jst, _ = jstep(jst)
        tst, tev = tworld.step_batched(tst, DT, kinds=kinds)
        jax_steps.append(jax.tree.map(np.asarray, jst))
        port_steps.append(to_numpy(tst))
        syncs.append(tev.host_syncs)
    return jscene, tscene, jax_steps, port_steps, syncs


def test_mixed_scene_builders_agree(mixed_run):
    jscene, tscene = mixed_run[:2]
    jn, tn = jax.tree.map(np.asarray, jscene), to_numpy(tscene)
    for grp in ("bodies", "fixtures", "contacts"):
        for f in dataclasses.fields(getattr(tn, grp)):
            assert np.array_equal(getattr(getattr(tn, grp), f.name)[0],
                                  getattr(getattr(jn, grp), f.name)), f"{grp}.{f.name}"
    for name in MIXED_TYPES:
        blk = getattr(tn.joints, name)
        assert blk.active.shape[1] >= 1, name
        for f in dataclasses.fields(blk):
            assert np.array_equal(getattr(blk, f.name)[0],
                                  getattr(getattr(jn.joints, name), f.name)), f"{name}.{f.name}"


def test_mixed_scene_step_matches_jax(mixed_run):
    """Every step: c, a to 2e-5; v, w to 1e-4; joint impulses to 1e-4;
    awake, limit states, the pair table and touch flags equal."""
    _, _, jax_steps, port_steps, syncs = mixed_run
    seen_limits, touched = set(), 0
    for i, (j, t) in enumerate(zip(jax_steps, port_steps)):
        jb, tb = j.bodies, t.bodies
        np.testing.assert_allclose(tb.c, jb.c, rtol=0, atol=2e-5, err_msg=f"c @{i}")
        np.testing.assert_allclose(tb.a, jb.a, rtol=0, atol=2e-5, err_msg=f"a @{i}")
        np.testing.assert_allclose(tb.v, jb.v, rtol=0, atol=1e-4, err_msg=f"v @{i}")
        np.testing.assert_allclose(tb.w, jb.w, rtol=0, atol=1e-4, err_msg=f"w @{i}")
        np.testing.assert_array_equal(tb.awake, jb.awake, err_msg=f"awake @{i}")
        for name in ("f_a", "f_b", "touching"):
            np.testing.assert_array_equal(getattr(t.contacts, name),
                                          getattr(j.contacts, name), err_msg=f"{name} @{i}")
        np.testing.assert_array_equal(t.cache.labels, j.cache.labels, err_msg=f"labels @{i}")
        for name in MIXED_TYPES:
            tj, jj = getattr(t.joints, name), getattr(j.joints, name)
            np.testing.assert_allclose(tj.impulse, jj.impulse, rtol=0, atol=1e-4,
                                       err_msg=f"{name}.impulse @{i}")
            if hasattr(tj, "limit_state"):
                np.testing.assert_allclose(tj.motor_impulse, jj.motor_impulse, rtol=0,
                                           atol=1e-4, err_msg=f"{name}.motor_impulse @{i}")
                np.testing.assert_array_equal(tj.limit_state, jj.limit_state,
                                              err_msg=f"{name}.limit_state @{i}")
                seen_limits.update((name, s) for s in set(tj.limit_state.reshape(-1).tolist()))
        touched = max(touched, int(t.contacts.touching.sum()))
    assert touched >= 6                                   # past first contact
    # the box welded in place (the last jointed body, slot 9) sleeps once
    # its joint has converged for half a second (so does the slider, held
    # at its limit); the swinging chain stays awake
    awake = port_steps[-1].bodies.awake
    assert not awake[:, 9].any() and awake[:, 1:4].all()
    assert port_steps[20].bodies.awake[:, 9].all()
    assert ("prismatic", 2) in seen_limits                # the slider hit its limit
    assert {s for n, s in seen_limits if n == "revolute"} - {0}
    # the joint coloring runs every step: its rounds are host reads
    assert min(syncs) >= 5
