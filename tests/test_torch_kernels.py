"""Card-only: the port's CUDA kernels against their plain PyTorch versions.

This file imports neither JAX nor the JAX package, so it runs on a GPU
host without them: `python -m pytest --noconftest tests/test_torch_kernels.py -q`.
Elsewhere every case skips. These cases are the card's check that each
kernel equals its plain version; chip_smoke.py holds each kernel on the
busiest step of full-size rolls and times it. Launches are counted at
`cuda_build.call`, by the C entry's name. Inputs are captured from the
port's own step (8 x pyramid(10) after 30 steps); max_colors=3 makes the
coloring overflow, which exercises the kernel's Jacobi chunk path. The
time-of-impact kernel gets the lanes of the step in which a pyramid's
bottom row reaches the ground, of fast boxes thrown at a thin wall, and of
chip_smoke.py's 4096 fast boxes at random angles and spins (more than half
their lanes touching), and golden lanes tiled to every launch shape of its
grid (no lane active, where every lane keeps t_max, one lane, a ragged
count, one active lane a warp, every lane active, spans of two segments
with more active lanes than a block has threads), each launched twice; its
wrapper's argument checks run on the CPU too.
The four sandwich kernels get the inputs of one step of 8 x tumbler(40)
(a joint world, after the boxes have landed), recorded through the
`sandwich=` hook, and the solve middle's inputs of joint-free pyramids at
every launch shape of the solve middle, the sweeps and the unpack: 128
contact slots (several worlds a block, the last block partly filled),
256 at 64 worlds with an overflow color (every block full), 1024, 4096
(more lanes than the shared-memory buffers hold, so the ring turns, and
the solve middle takes its ring path), an overflow color of
several chunks, a world without a solved lane, and slot counts that are
no multiple of 4 (rows not 16-byte aligned), on both of the solve
middle's paths, and 16 copies of a pyramid(44) world side by side in one
world (16384 bodies, 65536 slots: the body planes in global memory, K6's
scatter unpack). The position sweep also gets hand-built lanes of each
manifold type, and angles past sinf's fast range. Circles: K1 gets the
solve middle of 8 x sphere_stack(10) at a step whose solved lanes include
circle-circle (e_circles) manifolds, and K2 the lanes of fast circles
thrown at a static circle, a thin static box and an edge, where every
proxy B has one vertex and each lane runs several conservative-advancement
trips, its GJK warm-started from the previous trip's simplex.
The coloring kernel K7 equals the Luby tier's plain version (`_luby`) bit
for bit in color, rank and overflow: on seeded random batches (static
bodies, inactive slots, self-loops) at 1 and 512 worlds, 1 to 2048 slots,
64 to 1000 bodies (and 12000, past the default 48 KB of shared memory,
and 60000, past a block's shared memory, where the walk keeps its state in
global memory) and 1 to 32 colors, and on the colorings of the rolled
pyramids at 16 colors and at 3, where they overflow; `color_constraints`
launches it for every batch of the Luby tier on a card. Its wrapper's
argument checks run on the CPU too.
The TOI sub-step kernel K8 equals `toi_substep_passes_plain` bit for bit,
twice in a row, in every output (pose, velocity, the lanes' and the
neighbors' impulses, the neighbors' copies of the other endpoint's
velocity), on the sub-steps of fast boxes falling onto a ground of short
static edges (each solved lane keeps five neighbors: ranks 0-4), of a
bullet beside a resting box (a dynamic neighbor), of chip_smoke.py's
fast boxes at a thin wall, of unit circles landing on an edge
(sphere_stack) and of fast circles at a static circle, box and edge
(e_circles manifolds), with and without mini islands; on lanes cut from
them to every launch shape: no solved lane, one lane, a ragged count,
every lane solved and more lanes than one wave, with 0-4 kept neighbors
a lane; and launched from two shards' threads, each on its own stream.
On the CPU its wrapper refuses malformed arguments by
name and takes the plain version, which equals the passes in K8's order
of work (each lane's constraint, then its neighbors in slot order)
written out in PyTorch here."""

import collections
import contextlib
import ctypes
import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from box2d_mt_tpu_torch import cuda_build, settings, shapes
from box2d_mt_tpu_torch.models import scenes
from box2d_mt_tpu_torch.ops import coloring
from box2d_mt_tpu_torch.ops import solve_middle as sm
from box2d_mt_tpu_torch.ops import toi as ktoi
from box2d_mt_tpu_torch.ops.integrate import integrate_positions
from box2d_mt_tpu_torch.ops.sync import HostSyncs
from box2d_mt_tpu_torch.state import replicate
from box2d_mt_tpu_torch.world import WorldBuilder, step_batched

DT = 1.0 / 60.0


@contextlib.contextmanager
def launched():
    """Counts the CUDA launches the block makes at `cuda_build.call`, which
    every kernel's wrapper launches through, by the C entry's name:
    "solve_middle_launch" (K1), "toi_launch" (K2), "pack_packed_launch",
    "vel_iter_packed_launch", "pos_iter_packed_launch" and
    "unpack_packed_launch" (K3-K6), "color_launch" (K7) and
    "toi_substep_launch" (K8)."""
    ran = collections.Counter()
    call = cuda_build.call

    def counted_call(source, name, *args, **kwargs):
        out = call(source, name, *args, **kwargs)
        ran[name] += 1
        return out

    cuda_build.call = counted_call
    try:
        yield ran
    finally:
        cuda_build.call = call


@pytest.fixture(scope="module")
def rolled():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on a card")
    states = replicate(scenes.pyramid(10, device="cuda"), 8)
    for _ in range(30):
        states, _ = step_batched(states, DT, continuous=False, max_colors=16)
    return states


@pytest.mark.gpu
@pytest.mark.parametrize("max_colors", [16, 3], ids=["colors", "overflow"])
def test_solve_middle_kernel_matches_plain(rolled, max_colors):
    # recolor with this budget: the color cache does not key on max_colors
    states = dataclasses.replace(rolled, cache=dataclasses.replace(
        rolled.cache, valid=torch.zeros_like(rolled.cache.valid)))
    got = {}

    def capture(*args):
        got["args"] = args
        return sm.solve_middle(*args)

    _, ev = step_batched(states, DT, continuous=False, max_colors=max_colors,
                         middle=capture)
    assert (int(ev.color_overflow.min()) > 0) == (max_colors == 3)
    args = got["args"]
    with launched() as ran:
        k_vel, k_pos, k_aux = sm.solve_middle(*args)
    p_vel, p_pos, p_aux = sm.solve_middle_plain(*args)
    torch.cuda.synchronize()
    assert ran == {"solve_middle_launch": 1}
    torch.testing.assert_close(k_pos, p_pos, rtol=0, atol=1e-5)
    torch.testing.assert_close(k_vel, p_vel, rtol=0, atol=1e-4)
    torch.testing.assert_close(k_aux[:, :4], p_aux[:, :4], rtol=0, atol=1e-4)
    slop = -3.0 * settings.LINEAR_SLOP
    assert torch.equal(k_aux[:, 4] >= slop, p_aux[:, 4] >= slop)


def test_kernel_wrapper_checks_arguments():
    """The wrapper refuses malformed arguments before any launch."""
    nw, nc, nb = 1, 4, 3
    args = [torch.zeros(nw, 51, nc), torch.zeros(nw, nc, dtype=torch.int32),
            torch.zeros(nw, 3, dtype=torch.int32),
            torch.zeros(nw, nc, dtype=torch.uint8), torch.zeros(nw, 3, nb),
            torch.zeros(nw, 3, nb), torch.zeros(nw, nb, dtype=torch.bool)]
    vel, pos, aux = sm.solve_middle(*args, DT, 1, 1)
    assert aux.shape == (nw, 5, nc) and torch.equal(vel, args[4])
    bad = list(args)
    bad[1] = bad[1].long()
    with pytest.raises(ValueError, match="perm"):
        sm.solve_middle(*bad, DT, 1, 1)
    bad = list(args)
    bad[4] = torch.zeros(nw, nb, 3).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        sm.solve_middle(*bad, DT, 1, 1)


def _fast_boxes(n):
    """n worlds of a 0.2 m box thrown at 60-240 m/s at a thin static box."""
    wb = WorldBuilder(gravity=(0.0, 0.0))
    wall = wb.create_body(position=(2.0, 0.0))
    wb.create_fixture(wall, shapes.Polygon.box(0.05, 3.0))
    box = wb.create_body(body_type=settings.DYNAMIC_BODY, position=(0.0, 0.0))
    wb.create_fixture(box, shapes.Polygon.box(0.1, 0.1), density=1.0)
    states = replicate(wb.freeze(device="cuda"), n)
    g = torch.Generator(device="cpu").manual_seed(0)
    speed = 60.0 + 180.0 * torch.rand(n, generator=g)
    heading = 0.6 * torch.rand(n, generator=g) - 0.3
    v = states.bodies.v.clone()
    v[:, box] = torch.stack([speed * torch.cos(heading), speed * torch.sin(heading)], -1).cuda()
    return dataclasses.replace(states, bodies=dataclasses.replace(states.bodies, v=v))


@pytest.mark.gpu
@pytest.mark.parametrize("scene", ["pyramid", "fast_boxes", "spinning_fast_boxes"])
def test_toi_kernel_matches_plain(scene):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on a card")
    import chip_smoke
    states = {"pyramid": lambda: replicate(scenes.pyramid(10, device="cuda"), 8),
              "fast_boxes": lambda: _fast_boxes(512),
              # 4096 boxes also at random angles and spins, one lane a warp
              "spinning_fast_boxes": lambda: chip_smoke.fast_box_worlds(4096, "cuda")}[scene]()
    got = []

    def capture(*args):
        out = ktoi.time_of_impact_lanes(*args)
        if not got and bool((out[0] == 3).any()):
            got.append(args)
        return out

    for _ in range(30):
        states, _ = step_batched(states, DT, max_colors=16, toi=capture)
        if got:
            break
    assert got, "no lane reported touching"
    args = got[0]
    with launched() as ran:
        k_state, k_t = ktoi.time_of_impact_lanes(*args)
    p_state, p_t = ktoi.time_of_impact_lanes_plain(*args)
    torch.cuda.synchronize()
    assert ran == {"toi_launch": 1}
    # same arithmetic in the same order, built with --fmad=false: bit equal
    assert torch.equal(k_state, p_state)
    assert torch.equal(k_t, p_t)
    touching = int((k_state == 3).sum())
    assert touching > (int(args[-1].sum()) // 2 if scene == "spinning_fast_boxes" else 0)


_TOI_GOLDEN = pathlib.Path(__file__).resolve().parent / "golden" / "toi.jsonl"


def _golden_lanes(n, device, active=None):
    """n lanes in time_of_impact_lanes' argument contract, lane i a copy of
    golden lane i % 200 of tests/golden/toi.jsonl (147 separated, 38
    touching, 15 overlapped); `active` a bool mask (every lane if None)."""
    rows = [json.loads(line) for line in open(_TOI_GOLDEN)]
    pick = np.arange(n) % len(rows)

    def side(key, sweep_key):
        verts = np.zeros((len(rows), 2, 8), np.float32)
        sweep = np.zeros((len(rows), 8), np.float32)
        for i, r in enumerate(rows):
            vs = np.asarray(r[key]["verts"], np.float32)
            verts[i, :, :len(vs)] = vs.T
            sweep[i, 2:] = r[sweep_key]
        count = np.asarray([len(r[key]["verts"]) for r in rows], np.int32)
        radius = np.asarray([r[key]["radius"] for r in rows], np.float32)
        return [torch.from_numpy(np.ascontiguousarray(x)).to(device)
                for x in (verts[pick].transpose(1, 2, 0), count[pick], radius[pick],
                          sweep[pick].T)]

    act = torch.ones(n, dtype=torch.bool) if active is None else torch.as_tensor(active)
    return (*side("a", "sweepA"), *side("b", "sweepB"),
            torch.ones(n, device=device), act.to(device))


def _faulty(t, fault):
    """`t` with one fault: another dtype, one lane too few (a second axis
    for the 1-D `active`), another device, or a strided layout."""
    if fault == "dtype":
        return t.to({torch.float32: torch.float64, torch.int32: torch.int64,
                     torch.bool: torch.uint8}[t.dtype])
    if fault == "shape":
        return t[:, None] if t.dtype == torch.bool else t[..., :-1].contiguous()
    if fault == "device":
        return t.to("meta")
    wide = torch.zeros((*t.shape[:-1], 2 * t.shape[-1]), dtype=t.dtype)
    wide[..., ::2] = t
    return wide[..., ::2]


@pytest.mark.parametrize("fault", ["dtype", "shape", "device", "contiguous"])
def test_toi_wrapper_checks_arguments(fault):
    """The time-of-impact wrapper refuses each malformed argument by its
    name before any launch; well-formed CPU lanes take the plain version."""
    args = _golden_lanes(40, "cpu")
    state, t = ktoi.time_of_impact_lanes(*args)
    assert torch.equal(state, ktoi.time_of_impact_lanes_plain(*args)[0])
    assert int((state == 3).sum()) > 0
    for i, (name, _, _) in enumerate(ktoi._ARGS):
        bad = list(args)
        bad[i] = _faulty(args[i], fault)
        # the others' device is held against `active`'s
        match = ("active on meta" if (fault, name) == ("device", "active")
                 else f": {name} is on meta" if fault == "device" else f": {name} ")
        with pytest.raises(ValueError, match=match):
            ktoi.time_of_impact_lanes(*bad)


def _toi_case(case):
    """(lanes, active mask) of one launch shape of the time-of-impact
    kernel's grid (a block an SM, each over a span of lanes)."""
    if case == "inactive":
        return 4096, np.zeros(4096, bool)
    if case == "one_lane":
        return 1, np.ones(1, bool)
    if case == "ragged":                    # no multiple of 32: a short last span
        return 1001, np.arange(1001) % 3 != 1
    if case == "one_per_warp":              # the fast-box rounds' layout
        return 65536, np.arange(65536) % 32 == 7
    if case == "all_active":
        return 8192, np.ones(8192, bool)
    # spans of two segments, each with more active lanes than the block
    # has threads: warps solve batch after batch
    n = ktoi.grid(1 << 30)[0] * 3600 + 77
    return n, np.ones(n, bool)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["inactive", "one_lane", "ragged", "one_per_warp",
                                  "all_active", "long_spans"])
def test_toi_kernel_matches_plain_at_every_launch_shape(case):
    """Bit-equal to the plain version, twice in a row (a launch carries
    nothing over to the next)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on a card")
    n, active = _toi_case(case)
    args = _golden_lanes(n, "cuda", active)
    p_state, p_t = ktoi.time_of_impact_lanes_plain(*args)
    with launched() as ran:
        for _ in range(2):
            k_state, k_t = ktoi.time_of_impact_lanes(*args)
            torch.cuda.synchronize()
            assert torch.equal(k_state, p_state)
            assert torch.equal(k_t, p_t)
    assert ran == {"toi_launch": 2}
    blocks, span = ktoi.grid(n)
    assert blocks * span >= n > (blocks - 1) * span and span % 32 == 0
    on = torch.as_tensor(active).cuda()
    assert torch.all(k_state[~on] == 0) and torch.equal(k_t[~on], args[-2][~on])
    if active.any():
        assert int((k_state[on] != 0).sum()) > 0


class _RecordedSandwich:
    """A `sandwich=` hook that launches the kernels and keeps each call's
    inputs; the packed table is cloned before a sweep changes it."""

    def __init__(self):
        self.calls = {"pack": [], "vel_iter": [], "pos_iter": [], "unpack": []}

    def _keep(self, name, fn, args):
        self.calls[name].append(tuple(a.clone() for a in args))
        return fn(*args)

    def hook(self):
        return sm.Sandwich(
            lambda *a: self._keep("pack", sm.pack_packed, a),
            lambda *a: self._keep("vel_iter", sm.vel_iter_packed, a),
            lambda *a: self._keep("pos_iter", sm.pos_iter_packed, a),
            lambda *a: self._keep("unpack", sm.unpack_packed, a))


@pytest.fixture(scope="module")
def tumbler_calls():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on a card")
    states = replicate(scenes.tumbler(40, device="cuda"), 8)
    for _ in range(75):
        states, _ = step_batched(states, DT, max_colors=16)
    rec = _RecordedSandwich()
    with launched() as ran:
        step_batched(states, DT, max_colors=16, sandwich=rec.hook())
    assert [ran[k] for k in ("pack_packed_launch", "vel_iter_packed_launch",
                             "pos_iter_packed_launch", "unpack_packed_launch",
                             "solve_middle_launch")] == [1, 8, 3, 1, 0]
    return rec.calls


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["pack", "vel_iter", "pos_iter", "unpack"])
def test_sandwich_kernel_matches_plain(tumbler_calls, name):
    """Same arithmetic in the same order (--fmad=false): every output, and
    the packed table a sweep updates in place, equal to the bit."""
    kernel = getattr(sm.SANDWICH, name)
    plain = getattr(sm.SANDWICH_PLAIN, name)
    for args in tumbler_calls[name]:
        color_start = args[2]
        assert int(color_start[:, -1].sum()) > 50        # real contacts
        k_args = tuple(a.clone() for a in args)
        p_args = tuple(a.clone() for a in args)
        k_out, p_out = kernel(*k_args), plain(*p_args)
        torch.cuda.synchronize()
        if name == "pack":
            # positions past the solved lanes are unspecified in the kernel
            used = (torch.arange(k_out.shape[2], device="cuda")
                    < color_start[:, -1:])[:, None, :]
            k_out, p_out = torch.where(used, k_out, 0.0), torch.where(used, p_out, 0.0)
        assert torch.equal(k_out, p_out)
        if name in ("vel_iter", "pos_iter"):
            used = (torch.arange(args[0].shape[2], device="cuda")
                    < color_start[:, -1:])[:, None, :]
            assert torch.equal(torch.where(used, k_args[0], 0.0),
                               torch.where(used, p_args[0], 0.0))
            assert not torch.equal(k_args[0], args[0])   # updated in place


# name: (pyramid rows, worlds, steps, max_colors, variant); the boxes land
# row by row: pyramid(44) has 373 contacts after 30 steps, 1230 after 60
SHAPE_CASES = {
    "c128": (7, 6, 30, 16, None),
    "c1024": (22, 3, 30, 16, None),
    "c256_overflow_64_worlds": (10, 64, 30, 3, None),
    "c4096_ring": (44, 2, 60, 16, None),
    "c4096_overflow_chunks": (44, 2, 60, 3, None),
    "c128_empty_world": (7, 6, 30, 16, "empty_world"),
    "c130_unaligned": (7, 6, 30, 16, "unaligned"),
    "c258_unaligned_overflow": (10, 3, 30, 3, "unaligned"),
    "c4098_unaligned_ring": (44, 2, 60, 16, "unaligned"),
    # 16 copies of a pyramid(44) world side by side in one world: 16384
    # bodies and 65536 slots, where the body planes go to global memory
    "c65536_global_planes": (44, 2, 60, 16, "tiled"),
    "c65536_global_planes_overflow": (44, 2, 60, 3, "tiled"),
}
TILES = 16


def _tiled(args, k):
    """The solve middle's arguments of k copies of each world side by side
    in one world: copy j's bodies at j * N, its slots at j * C; each
    color holds the copies' lanes of that color, copy after copy."""
    blob, perm, color_start, dyn_ab, vel, pos, movable, *rest = args
    nw, _, nc = blob.shape
    nb = vel.shape[-1]
    blob = torch.cat([blob + torch.zeros_like(blob).index_fill_(1, torch.tensor(
        [1, 2], device=blob.device), float(j * nb)) for j in range(k)], 2)
    cs = color_start.tolist()
    perms = []
    for w in range(nw):
        bounds = list(zip(cs[w][:-1], cs[w][1:])) + [(cs[w][-1], nc)]
        perms.append(torch.cat([perm[w, a:b] + j * nc for a, b in bounds for j in range(k)]))
    return (blob.contiguous(), torch.stack(perms).contiguous(), (color_start * k).contiguous(),
            dyn_ab.repeat(1, k), vel.repeat(1, 1, k), pos.repeat(1, 1, k), movable.repeat(1, k),
            *rest)


@pytest.fixture(scope="module", params=list(SHAPE_CASES))
def middle_args(request):
    """The solve middle's arguments of one step of a joint-free pyramid."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on a card")
    rows, n_worlds, n_steps, max_colors, variant = SHAPE_CASES[request.param]
    states = replicate(scenes.pyramid(rows, device="cuda"), n_worlds)
    got = {}

    def capture(*args):
        got["args"] = args
        return sm.solve_middle(*args)

    for _ in range(n_steps):
        states, _ = step_batched(states, DT, continuous=False, max_colors=max_colors,
                                 middle=capture)
    blob, perm, color_start, dyn_ab, *rest = got["args"]
    if variant == "empty_world":
        color_start = color_start.clone()
        color_start[1] = 0
    if variant == "unaligned":
        pad = lambda t: torch.nn.functional.pad(t, (0, 2)).contiguous()
        blob, perm, dyn_ab = pad(blob), pad(perm), pad(dyn_ab)
    args = (blob, perm, color_start, dyn_ab, *rest)
    if variant == "tiled":
        args = _tiled(args, TILES)
    return request.param, args


def _sandwich(blob, perm, color_start, dyn_ab, vel, pos, movable, dt, vi, pi):
    table = sm.pack_packed(blob, perm, color_start)
    for _ in range(vi):
        vel = sm.vel_iter_packed(table, perm, color_start, dyn_ab, vel)
    c, a, v, w = integrate_positions(pos[:, 0:2].transpose(1, 2), pos[:, 2],
                                     vel[:, 0:2].transpose(1, 2), vel[:, 2], dt, movable)
    vel = torch.stack([v[..., 0], v[..., 1], w], 1).contiguous()
    pos = torch.stack([c[..., 0], c[..., 1], a], 1).contiguous()
    for _ in range(pi):
        pos = sm.pos_iter_packed(table, perm, color_start, dyn_ab, pos)
    return vel, pos, sm.unpack_packed(table, perm, color_start)


@pytest.mark.gpu
def test_solve_middle_kernel_matches_plain_at_every_shape(middle_args):
    """K1 against its plain version at every launch shape, on its
    resident path up to 1024 slots and its ring path beyond, with the body
    planes in global memory at 16384 bodies."""
    name, args = middle_args
    blob, perm, color_start = args[:3]
    nc, nb = blob.shape[2], args[4].shape[2]
    shape = sm.middle_shape(nb, nc, color_start.shape[1] - 1)
    assert shape.resident == (nc <= 1024)
    assert shape.global_planes == ("global_planes" in name)
    with launched() as ran:
        k_vel, k_pos, k_aux = sm.solve_middle(*args)
    p_vel, p_pos, p_aux = sm.solve_middle_plain(*args)
    torch.cuda.synchronize()
    assert ran == {"solve_middle_launch": 1}
    torch.testing.assert_close(k_pos, p_pos, rtol=0, atol=1e-5)
    torch.testing.assert_close(k_vel, p_vel, rtol=0, atol=1e-4)
    torch.testing.assert_close(k_aux[:, :4], p_aux[:, :4], rtol=0, atol=1e-4)
    slop = -3.0 * settings.LINEAR_SLOP
    assert torch.equal(k_aux[:, 4] >= slop, p_aux[:, 4] >= slop)


@pytest.mark.gpu
def test_sandwich_kernels_equal_solve_middle_kernel(middle_args):
    """K3 -> 8 x K4 -> integrate -> 3 x K5 -> K6 is K1 to the bit at every
    launch shape, on both of K1's paths and with the body planes in global
    memory: all run one sweep implementation and apply an overflow chunk's
    deltas in lane order."""
    name, args = middle_args
    blob, perm, color_start = args[:3]
    nc, nb = blob.shape[2], args[4].shape[2]
    lanes = color_start[:, -1]
    shape = sm.sweep_shape(nb, nc, color_start.shape[1] - 1)
    assert sm.middle_shape(nb, nc, color_start.shape[1] - 1).resident == (nc <= 1024)
    assert int(lanes.sum()) > 20
    if name.startswith("c128"):
        assert shape.worlds_per_block > 1 and blob.shape[0] % shape.worlds_per_block
        assert sm.unpack_shape(blob.shape[0], nc)[0] > 1
    if name == "c128_empty_world":
        assert int(lanes[1]) == 0
    if name.startswith("c4096") or name.startswith("c65536"):
        assert int(lanes.max()) > shape.tile * shape.n_buffers      # the ring turns
    assert shape.global_planes == ("global_planes" in name)
    if "overflow" in name:
        overflow = int((color_start[:, -1] - color_start[:, -2]).max())
        assert overflow > (1 if name.startswith(("c128", "c256", "c258")) else sm.CK)
    want = sm.solve_middle(*args)
    got = _sandwich(*args)
    torch.cuda.synchronize()
    for label, x, y in zip(("vel", "pos", "aux"), got, want):
        assert torch.equal(x, y), label
    assert float(want[2][:, :4].abs().max()) > 0.01


@pytest.mark.gpu
def test_sweep_and_unpack_kernels_match_plain(middle_args):
    """K4 and K6 alone against their plain versions: K6 moves values, so to
    the bit; K4 to the bit except in an overflow color, whose plain
    scatter sum is unordered on a card (atol 1e-4 on velocities)."""
    name, args = middle_args
    blob, perm, color_start, dyn_ab, vel = args[:5]
    table = sm.pack_packed_plain(blob, perm, color_start)
    for _ in range(2):
        k_table, p_table = table.clone(), table.clone()
        k_vel = sm.vel_iter_packed(k_table, perm, color_start, dyn_ab, vel)
        p_vel = sm.vel_iter_packed_plain(p_table, perm, color_start, dyn_ab, vel)
        torch.cuda.synchronize()
        if "overflow" in name:
            torch.testing.assert_close(k_vel, p_vel, rtol=0, atol=1e-4)
            torch.testing.assert_close(k_table, p_table, rtol=0, atol=1e-4)
        else:
            assert torch.equal(k_vel, p_vel) and torch.equal(k_table, p_table)
        assert not torch.equal(k_table, table)               # updated in place
        assert torch.equal(sm.unpack_packed(k_table, perm, color_start),
                           sm.unpack_packed_plain(k_table, perm, color_start))
        table, vel = k_table, k_vel


@pytest.mark.gpu
@pytest.mark.parametrize("n_bodies,n_contacts", [(32, 128), (64, 258), (256, 1024),
                                                 (1024, 4096), (16384, 65536)])
def test_sweep_shared_memory_matches_the_kernels_layout(n_bodies, n_contacts):
    """`sweep_shape` budgets a block's shared memory with its own copy of
    the kernel's layout sum, the global-planes layout's too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are built only on a card")
    from box2d_mt_tpu_torch.cuda_build import load
    fn = load("solve_middle").sweep_world_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int] * 7, ctypes.c_int
    for velocity, rows in ((1, sm.VEL_ROWS), (0, sm.POS_ROWS)):
        shape = sm.sweep_shape(n_bodies, n_contacts, 16, rows)
        world = fn(velocity, n_bodies, n_contacts, 16, shape.tile, shape.n_buffers,
                   int(shape.global_planes))
        assert shape.smem_bytes == shape.worlds_per_block * world


@pytest.mark.gpu
@pytest.mark.parametrize("n_bodies,n_contacts", [(32, 128), (64, 258), (256, 1024),
                                                 (1024, 4096), (8192, 32768), (16384, 65536)])
def test_middle_shared_memory_matches_the_kernels_layout(n_bodies, n_contacts):
    """`middle_shape` budgets a block's shared memory with its own copy of
    K1's layout sum, on the resident path, on the ring path and with the
    body planes in global memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are built only on a card")
    from box2d_mt_tpu_torch.cuda_build import load
    fn = load("solve_middle").middle_world_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int] * 7, ctypes.c_int
    for mc in (3, 16):
        shape = sm.middle_shape(n_bodies, n_contacts, mc)
        assert shape.smem_bytes == fn(int(shape.resident), n_bodies, n_contacts, mc,
                                      shape.tile, shape.n_buffers, int(shape.global_planes))


# lanes of one manifold type each (circles 0, face A 1, face B 2), or of
# all three mixed with angles far past 105615 rad, where sinf and cosf
# leave their fast range reduction
SYNTHETIC_LANES = ["circles", "face_a", "face_b", "mixed_large_angles"]


def _synthetic_position_lanes(case, n_worlds=2, n_lanes=96, seed=7):
    """A packed table of position lanes built by hand: lane l joins bodies
    2l and 2l + 1 (both dynamic), so one color holds every lane; numpy
    draws masses, local geometry, point counts, poses and angles."""
    rng = np.random.default_rng(seed)
    nb = 2 * n_lanes
    table = np.zeros((n_worlds, sm.PACKED_ROWS, n_lanes), np.float32)
    u = lambda lo, hi: rng.uniform(lo, hi, (n_worlds, n_lanes)).astype(np.float32)
    table[:, 0] = 1.0
    table[:, 1] = 2 * np.arange(n_lanes)
    table[:, 2] = 2 * np.arange(n_lanes) + 1
    table[:, 3] = rng.integers(1, 3, (n_worlds, n_lanes))
    for k in (6, 7, 8, 9):                           # ma, mb, iA, iB
        table[:, k] = u(0.1, 2.0)
    for k in range(32, 36):                          # the two local points
        table[:, k] = u(-0.5, 0.5)
    ang = u(0.0, 2 * np.pi)
    table[:, 36], table[:, 37] = np.cos(ang), np.sin(ang)   # local normal
    table[:, 38], table[:, 39] = u(-0.5, 0.5), u(-0.5, 0.5)  # local point
    table[:, 40], table[:, 41] = u(0.0, 0.1), u(0.0, 0.1)    # radii
    for k in range(42, 46):                          # local centers
        table[:, k] = u(-0.2, 0.2)
    kinds = {"circles": 0, "face_a": 1, "face_b": 2}
    table[:, 46] = (kinds[case] if case in kinds
                    else rng.integers(0, 3, (n_worlds, n_lanes)))
    pos = np.zeros((n_worlds, 3, nb), np.float32)
    pos[:, 0:2] = rng.uniform(-0.3, 0.3, (n_worlds, 2, nb))
    if case == "mixed_large_angles":
        big = rng.uniform(1.1e5, 3e7, (n_worlds, nb)) * rng.choice([-1.0, 1.0], (n_worlds, nb))
        pos[:, 2] = big
        pos[0, 2, :8] = [0.0, -0.0, 105615.0, -105615.0, 105616.0, -105616.0,
                         1e30, np.pi]
    else:
        pos[:, 2] = rng.uniform(-3.0, 3.0, (n_worlds, nb))
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).cuda()
    perm = t(np.tile(np.arange(n_lanes, dtype=np.int32), (n_worlds, 1)))
    color_start = t(np.tile(np.asarray([0, n_lanes, n_lanes], np.int32), (n_worlds, 1)))
    dyn_ab = t(np.full((n_worlds, n_lanes), 3, np.uint8))
    return t(table), perm, color_start, dyn_ab, t(pos)


@pytest.mark.gpu
@pytest.mark.parametrize("case", SYNTHETIC_LANES)
def test_position_sweep_kernel_matches_plain_on_synthetic_lanes(case):
    """K5 evaluates only a lane's own manifold type and takes sine and
    cosine from one sincosf: its positions and min_sep equal the plain
    version's (torch.sin, torch.cos, all three types selected) to the bit,
    through three sweeps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on a card")
    table, perm, color_start, dyn_ab, pos = _synthetic_position_lanes(case)
    k_table, p_table, k_pos, p_pos = table.clone(), table.clone(), pos, pos
    for _ in range(3):
        k_pos = sm.pos_iter_packed(k_table, perm, color_start, dyn_ab, k_pos)
        p_pos = sm.pos_iter_packed_plain(p_table, perm, color_start, dyn_ab, p_pos)
        torch.cuda.synchronize()
        assert torch.equal(k_pos, p_pos)
        assert torch.equal(k_table, p_table)
    assert bool(torch.isfinite(k_pos).all())
    assert float((k_pos - pos).abs().max()) > 1e-3           # the lanes moved bodies
    assert float(k_table[:, sm.MIN_SEP_ROW].min()) < 0.0     # and found overlap


def _fast_circles(n, seed=3, device="cuda"):
    """n worlds of three 0.1 m circles thrown at 60-240 m/s at a static
    circle, a thin static box and an edge, 2 m away."""
    wb = WorldBuilder(gravity=(0.0, 0.0))
    targets = wb.create_body(position=(2.0, 0.0))
    wb.create_fixture(targets, shapes.Circle(0.3, (0.0, -4.0)))
    wb.create_fixture(targets, shapes.Polygon.box(0.05, 1.0))
    wb.create_fixture(targets, shapes.Edge((0.0, 3.0), (0.0, 5.0)))
    for y in (-4.0, 0.0, 4.0):
        b = wb.create_body(body_type=settings.DYNAMIC_BODY, position=(0.0, y))
        wb.create_fixture(b, shapes.Circle(0.1), density=1.0)
    states = replicate(wb.freeze(device=device), n)
    rng = np.random.default_rng(seed)
    speed = rng.uniform(60.0, 240.0, (n, 3))
    heading = rng.uniform(-0.05, 0.05, (n, 3))
    v = states.bodies.v.clone()
    v[:, 1:4] = torch.as_tensor(np.stack([speed * np.cos(heading), speed * np.sin(heading)],
                                         -1), dtype=torch.float32, device=device)
    return dataclasses.replace(states, bodies=dataclasses.replace(states.bodies, v=v))


@pytest.mark.gpu
def test_toi_kernel_matches_plain_on_circle_proxies():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on a card")
    states = _fast_circles(512)
    got = []

    def capture(*args):
        out = ktoi.time_of_impact_lanes(*args)
        if not got and bool((out[0] == 3).any()):
            got.append(args)
        return out

    states, _ = step_batched(states, DT, max_colors=16, toi=capture)
    assert got, "no lane reported touching"
    args = got[0]
    k_state, k_t = ktoi.time_of_impact_lanes(*args)
    p_state, p_t = ktoi.time_of_impact_lanes_plain(*args)
    assert torch.equal(k_state, p_state) and torch.equal(k_t, p_t)
    active = args[-1]
    count_a, count_b = args[1], args[5]
    assert bool((count_b[active] == 1).all())
    for n_verts in (1, 4, 2):               # the circle, the box, the edge
        lanes = active & (count_a == n_verts)
        assert int((lanes & (k_state == 3)).sum()) > 100, n_verts


@pytest.mark.gpu
def test_solve_middle_kernel_matches_plain_on_circles():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on a card")
    states = replicate(scenes.sphere_stack(10, device="cuda"), 8)
    got = {}

    def capture(*args):
        blob, perm, color_start = args[:3]
        used = torch.arange(perm.shape[1], device=perm.device) < color_start[:, -1:]
        circles = (blob[:, 46].gather(1, perm.long()) == settings.MANIFOLD_CIRCLES) & used
        if "args" not in got and int(circles.sum()) >= 8 * 4:
            got["args"] = args
        return sm.solve_middle(*args)

    for _ in range(60):
        states, _ = step_batched(states, DT, max_colors=16, middle=capture)
        if "args" in got:
            break
    assert "args" in got, "no step solved circle-circle lanes"
    args = got["args"]
    k_vel, k_pos, k_aux = sm.solve_middle(*args)
    p_vel, p_pos, p_aux = sm.solve_middle_plain(*args)
    torch.testing.assert_close(k_pos, p_pos, rtol=0, atol=1e-5)
    torch.testing.assert_close(k_vel, p_vel, rtol=0, atol=1e-4)
    torch.testing.assert_close(k_aux[:, :4], p_aux[:, :4], rtol=0, atol=1e-4)
    slop = -3.0 * settings.LINEAR_SLOP
    assert torch.equal(k_aux[:, 4] >= slop, p_aux[:, 4] >= slop)


# ---- K7: the constraint coloring, Luby tier


def _color_graphs(w, k, n, seed, device):
    """W random worlds of K slots over N bodies: ~20% static bodies, ~20%
    inactive slots, ~5% self-loops (body_a == body_b)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, n, (w, k))
    b = rng.integers(0, n, (w, k))
    loop = rng.random((w, k)) < 0.05
    b[loop] = a[loop]
    dynamic = rng.random((w, n)) >= 0.2
    graph = (a, b, np.take_along_axis(dynamic, a, 1), np.take_along_axis(dynamic, b, 1),
             rng.random((w, k)) >= 0.2)
    return tuple(torch.from_numpy(x).to(device) for x in graph)


def _same_as_luby(args, n, max_colors):
    """K7 against `_luby` on the same card tensors: color, rank and
    overflow bit-equal. Returns the overflow."""
    with launched() as ran:
        color, overflow, rank = coloring.color_walk(*args, n, max_colors)
    want = coloring._luby(*args, n, max_colors, HostSyncs())
    torch.cuda.synchronize()
    assert ran == {"color_launch": 1}
    assert color.dtype == rank.dtype == overflow.dtype == torch.int32
    for got, plain, name in zip((color, overflow, rank), want,
                                ("color", "overflow", "rank")):
        assert torch.equal(got, plain), (name, n, max_colors)
    return overflow


@pytest.mark.gpu
@pytest.mark.parametrize("n", [64, 256, 1000])
@pytest.mark.parametrize("k", [1, 256, 1024, 2048])
@pytest.mark.parametrize("w", [1, 512])
def test_coloring_kernel_matches_luby(w, k, n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on a card")
    args = _color_graphs(w, k, n, seed=w * 7919 + k * 31 + n, device="cuda")
    for max_colors in (1, 3, 16, 32):
        overflow = _same_as_luby(args, n, max_colors)
        if max_colors == 1:
            assert torch.equal(overflow, args[-1].sum(1, dtype=torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [12000, 60000], ids=["past_default", "past_block"])
def test_coloring_kernel_matches_luby_past_shared_memory(n):
    """12000 bodies: 64.5 KB of shared memory a world, past the 48 KB a
    launch gets without asking; 60000: 248 KB, past the 227 KB a block may
    take, so the walk keeps its endpoints and body masks in global memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on a card")
    args = _color_graphs(2, 2048, n, seed=n, device="cuda")
    for max_colors in (3, 32):
        _same_as_luby(args, n, max_colors)


@pytest.mark.gpu
@pytest.mark.parametrize("max_colors", [16, 3], ids=["colors", "overflow"])
def test_coloring_kernel_matches_luby_on_rolled_pyramids(rolled, max_colors):
    """The step's own colorings: the step launches K7 once, and K7 equals
    `_luby` on its arguments."""
    states = dataclasses.replace(rolled, cache=dataclasses.replace(
        rolled.cache, valid=torch.zeros_like(rolled.cache.valid)))
    got = []
    plain = coloring.color_constraints

    def capture(*args, **kwargs):
        got.append((args, kwargs))
        return plain(*args, **kwargs)

    coloring.color_constraints = capture
    try:
        with launched() as ran:
            _, ev = step_batched(states, DT, continuous=False, max_colors=max_colors)
    finally:
        coloring.color_constraints = plain
    assert len(got) == 1 and ran["color_launch"] == 1
    (ba, bb, dyn_a, dyn_b, active, n, mc), _ = got[0]
    assert mc == max_colors and int(active.sum()) > 0
    overflow = _same_as_luby((ba, bb, dyn_a, dyn_b, active), n, max_colors)
    assert torch.equal(overflow, ev.color_overflow.to(torch.int32))
    assert (int(overflow.min()) > 0) == (max_colors == 3)


@pytest.mark.gpu
def test_coloring_dispatch_launches_on_every_luby_batch():
    """`color_constraints` takes K7 for every batch of at most 2048 slots
    on a card, a world past a block's shared memory included,
    Jones-Plassmann above 2048 slots and `_luby` on the CPU; the event
    "coloring.kernel" counts the launches. A card refuses more than 32
    colors, as Jones-Plassmann does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on a card")
    for w, k, n, device, launches in ((4, 1024, 256, "cuda", 1),
                                      (1, 2048, 60000, "cuda", 1),
                                      (2, 2049, 256, "cuda", 0),
                                      (4, 1024, 256, "cpu", 0)):
        args = _color_graphs(w, k, n, seed=k + n, device=device)
        syncs = HostSyncs()
        with launched() as ran:
            color, overflow, rank = coloring.color_constraints(
                *args, n, 16, with_rank=True, syncs=syncs)
        assert ran["color_launch"] == launches
        assert syncs.events.get("coloring.kernel", 0) == launches
        assert (syncs.count == 0) == (launches == 1)        # no host read
        if k <= 2048:
            want = coloring._luby(*args, n, 16, HostSyncs())
            for got, plain in zip((color, overflow, rank), want):
                assert torch.equal(got, plain)
    syncs = HostSyncs()
    with pytest.raises(ValueError, match="max_colors=33"), launched() as ran:
        coloring.color_constraints(*_color_graphs(1, 64, 16, seed=1, device="cuda"), 16, 33,
                                   syncs=syncs)
    assert ran["color_launch"] == 0 and "coloring.kernel" not in syncs.events


def test_coloring_wrapper_checks_arguments():
    """K7's wrapper refuses malformed arguments before any launch: dtype,
    shape, device and contiguity of each tensor, colors and worlds past
    the kernel, and CPU tensors."""
    args = [torch.zeros(2, 8, dtype=torch.int64), torch.ones(2, 8, dtype=torch.int64),
            torch.ones(2, 8, dtype=torch.bool), torch.ones(2, 8, dtype=torch.bool),
            torch.ones(2, 8, dtype=torch.bool)]

    def refused(match, bad, n=4, max_colors=16):
        with pytest.raises(ValueError, match=match):
            coloring.color_walk(*bad, n, max_colors)

    def replaced(i, t):
        return args[:i] + [t] + args[i + 1:]

    names = ("body_a", "body_b", "conflict_a", "conflict_b", "active")
    for i, name in enumerate(names):
        t = args[i]
        refused(f"{name} must be torch.", replaced(i, t.to(torch.int32)))
        refused("contiguous", replaced(i, t.t().contiguous().t()))
        if i:
            refused(f"{name} must be torch.*shape \\(2, 8\\)", replaced(i, t[:, :7].clone()))
            refused(f"{name} is on meta", replaced(i, t.to("meta")))
    refused("body_a must be \\(W, K\\)", replaced(0, args[0][0]))
    refused("max_colors", args, max_colors=0)
    refused("max_colors", args, max_colors=33)
    refused("CUDA tensors", args)


# ---- K8: the TOI sub-step's passes ------------------------------------------


def _segmented_ground(n, device):
    """n worlds of a 1 m box falling at 60 m/s onto a ground of 0.2 m static
    edges, each box a little turned and moved sideways: its sub-step
    keeps the four or five other edges under it as neighbors."""
    wb = WorldBuilder(gravity=(0.0, -10.0))
    ground = wb.create_body()
    for i in range(20):
        wb.create_fixture(ground, shapes.Edge((-2.0 + 0.2 * i, 0.0), (-1.8 + 0.2 * i, 0.0)))
    box = wb.create_body(body_type=settings.DYNAMIC_BODY, position=(0.03, 1.5),
                         linear_velocity=(0.0, -60.0))
    wb.create_fixture(box, shapes.Polygon.box(0.5, 0.5), density=1.0)
    states = replicate(wb.freeze(device=device), n)
    g = torch.Generator(device="cpu").manual_seed(1)
    b = states.bodies
    a, c = b.a.clone(), b.c.clone()
    a[:, box] = (0.02 * (torch.rand(n, generator=g) - 0.5)).to(device)
    c[:, box, 0] = (0.3 * (torch.rand(n, generator=g) - 0.5)).to(device)
    return dataclasses.replace(states, bodies=dataclasses.replace(
        b, a=a, a0=a.clone(), c=c, c0=c.clone()))


def fast_box_builder(builder, shapes, settings):
    """A box thrown at a thin wall, and a bullet landing beside a resting
    box: the bullet's sub-step keeps that dynamic box as a neighbor. Built
    with either package's WorldBuilder, shapes and settings."""
    wb = builder(gravity=(0.0, -10.0))
    ground = wb.create_body()
    wb.create_fixture(ground, shapes.Edge((-40.0, 0.0), (40.0, 0.0)))
    wall = wb.create_body(position=(10.0, 5.0))
    wb.create_fixture(wall, shapes.Polygon.box(0.05, 5.0))
    box = wb.create_body(body_type=settings.DYNAMIC_BODY, position=(1.5, 5.0),
                         linear_velocity=(200.0, 0.0))
    wb.create_fixture(box, shapes.Polygon.box(0.1, 0.1), density=1.0)
    rest = wb.create_body(body_type=settings.DYNAMIC_BODY, position=(-20.0, 0.5))
    wb.create_fixture(rest, shapes.Polygon.box(0.5, 0.5), density=1.0)
    bullet = wb.create_body(body_type=settings.DYNAMIC_BODY, position=(-18.99, 4.0),
                            bullet=True, linear_velocity=(0.0, -100.0))
    wb.create_fixture(bullet, shapes.Polygon.box(0.5, 0.5), density=1.0)
    return wb


def _bullet_beside_box(n, device):
    return replicate(fast_box_builder(WorldBuilder, shapes, settings).freeze(device=device), n)


@contextlib.contextmanager
def _recording_substeps():
    """Yields the list of every sub-step's passes taken in the block, from
    any thread, at the wrapper's branch on the device: the arguments and
    velocity iterations, and K8's results where it ran (None on the CPU)."""
    calls = []
    launch, plain = ktoi._substep_launch, ktoi.toi_substep_passes_plain

    def keep_launch(args, iterations):
        out = launch(args, iterations)
        calls.append((tuple(a.clone() for a in args), iterations,
                      tuple(o.clone() for o in out)))
        return out

    def keep_plain(*args, iterations, syncs=None):
        calls.append((tuple(a.clone() for a in args), iterations, None))
        return plain(*args, iterations=iterations, syncs=syncs)

    ktoi._substep_launch, ktoi.toi_substep_passes_plain = keep_launch, keep_plain
    try:
        yield calls
    finally:
        ktoi._substep_launch, ktoi.toi_substep_passes_plain = launch, plain


def _substep_calls(states, n_steps, **kw):
    """The arguments of every sub-step's passes over n_steps, each with its
    velocity iterations."""
    with _recording_substeps() as calls:
        for _ in range(n_steps):
            states, _ = step_batched(states, DT, max_colors=8, **kw)
    assert calls, "no TOI sub-step"
    return [(args, iterations) for args, iterations, _ in calls]


def _kept(args):
    return args[7][1]


@pytest.fixture(scope="module")
def cpu_substeps():
    """The first sub-step of 8 segmented grounds and of 2 bullet worlds, on
    the CPU."""
    ground = _substep_calls(_segmented_ground(8, "cpu"), 1)[0]
    bullet = [c for c in _substep_calls(_bullet_beside_box(2, "cpu"), 3)
              if int(_kept(c[0]).sum())][0]
    return {"segmented_ground": ground, "bullet": bullet}


def _lane_order(args, iterations):
    """The sub-step's passes in K8's order of work, in PyTorch: every lane
    at once applies its own constraint and then its r-th kept neighbor for
    r = 0, 1, ..., gathered by lane (no scatter); the neighbors' results
    go to their places at the end."""
    from box2d_mt_tpu_torch.ops import solver
    (solve, kind, manifold, body, material, pose, vel, span, parent, order, nb_kind,
     nb_manifold, nb_body, nb_material, nb_other) = args
    start, count = span.long()
    n_nb = parent.shape[0]
    ids = [order.long()[(start + r).clamp(0, n_nb - 1)] for r in range(int(count.max()))]
    has = [count[None] > r for r in range(len(ids))]

    def contact(kind_, manifold_, material_, lanes=None):
        pick = (lambda t: t) if lanes is None else (lambda t: t[:, lanes])
        mtype, npts = pick(kind_)[:2, None]
        lpx, lpy, lnx, lny, p0x, p0y, p1x, p1y = pick(manifold_)[:, None]
        return dict(mtype=mtype, count=npts, lp=(lpx, lpy), ln=(lnx, lny),
                    pts=((p0x, p1x), (p0y, p1y)), mat=tuple(pick(material_)[:, None]),
                    man=(mtype, torch.stack([lpx, lpy], -1), torch.stack([lnx, lny], -1),
                         torch.stack([torch.stack([p0x, p0y], -1),
                                      torch.stack([p1x, p1y], -1)], -2), npts))

    def pos_args(k, lc_a, lc_b, ra, rb):
        return (ra, rb, *lc_a, *lc_b, *k["lp"], *k["ln"], *k["pts"])

    own = contact(kind, manifold, material)
    m_a, m_b, i_a, i_b, lcax, lcay, lcbx, lcby, ra, rb = body[:, None]
    lane_pos_args = pos_args(own, (lcax, lcay), (lcbx, lcby), ra, rb)
    nbrs = []
    for lanes in ids:
        k = contact(nb_kind, nb_manifold, nb_material, lanes)
        nb = nb_body[:, lanes][:, None]
        k.update(toi_a=(nb_kind[2, lanes] != 0)[None], side_a=(nb_kind[3, lanes] != 0)[None],
                 p_mass=tuple(nb[0:4]), v_mass=tuple(nb[4:8]),
                 lc=(tuple(nb[8:10]), tuple(nb[10:12])), r=tuple(nb[12:14]),
                 other=nb_other[:, lanes][:, None], lanes=lanes)
        k["pos_args"] = pos_args(k, *k["lc"], *k["r"])
        nbrs.append(k)

    def split(k, six, other3):
        """The neighbor's six endpoint values: the TOI body's from the
        lane's six, the other endpoint's from other3."""
        t = [torch.where(k["side_a"], six[i], six[i + 3]) for i in range(3)]
        return ([torch.where(k["toi_a"], t[i], other3[i]) for i in range(3)]
                + [torch.where(k["toi_a"], other3[i], t[i]) for i in range(3)]), t

    def add_own(k, six, d, on):
        out = list(six)
        for i in range(3):
            out[i] = torch.where(on & k["side_a"], six[i] + d[i], six[i])
            out[i + 3] = torch.where(on & ~k["side_a"], six[i + 3] + d[i], six[i + 3])
        return out

    def toi_part(k, six):
        return [torch.where(k["toi_a"], six[i], six[i + 3]) for i in range(3)]

    on = solve[None]
    pos = list(pose[:, None])
    for _ in range(ktoi.TOI_POSITION_PASSES):
        pos = list(solver.position_contact_math_s(
            own["mtype"], own["count"], m_a, m_b, i_a, i_b, *lane_pos_args, *pos, on,
            settings.TOI_BAUMGARTE, settings.MAX_LINEAR_CORRECTION)[:6])
        for k, act in zip(nbrs, has):
            before, t = split(k, pos, k["other"][0:3])
            after = solver.position_contact_math_s(
                k["mtype"], k["count"], *k["p_mass"], *k["pos_args"], *before, act,
                settings.TOI_BAUMGARTE, settings.MAX_LINEAR_CORRECTION)
            pos = add_own(k, pos, [a - b for a, b in zip(toi_part(k, after), t)], act)

    def prep(k, six, vel6, masses):
        (lc_a, lc_b), (r_a, r_b) = k["lc"], k["r"]
        return ktoi._velocity_prep(
            *k["man"], torch.stack(six[0:2], -1), six[2], torch.stack(lc_a, -1), r_a,
            torch.stack(six[3:5], -1), six[5], torch.stack(lc_b, -1), r_b, *masses,
            torch.stack(vel6[0:2], -1), vel6[2], torch.stack(vel6[3:5], -1), vel6[5],
            k["mat"][1])

    v0 = list(vel[:, None])
    own.update(lc=((lcax, lcay), (lcbx, lcby)), r=(ra, rb))
    lane_args = prep(own, pos, v0, (m_a, m_b, i_a, i_b))
    zero = torch.zeros_like(m_a)
    for k in nbrs:
        six, _ = split(k, pos, k["other"][0:3])
        w0, _ = split(k, v0, k["other"][3:6])
        k["vel_args"] = prep(k, six, w0, k["v_mass"])
        k["nn"], k["nt"], k["ov"] = (zero, zero), (zero, zero), list(k["other"][3:6])
    ni, ti, v = (zero, zero), (zero, zero), v0
    for _ in range(iterations):
        ni, ti, *v = solver.velocity_contact_math_s(
            own["mat"][0], own["mat"][2], m_a, m_b, i_a, i_b, *lane_args, ni, ti, *v, on)
        for k, act in zip(nbrs, has):
            before, t = split(k, v, k["ov"])
            k["nn"], k["nt"], *after = solver.velocity_contact_math_s(
                k["mat"][0], k["mat"][2], *k["v_mass"], *k["vel_args"], k["nn"], k["nt"],
                *before, act)
            v = add_own(k, v, [a - b for a, b in zip(toi_part(k, after), t)], act)
            other = [torch.where(k["toi_a"], after[i + 3], after[i]) for i in range(3)]
            k["ov"] = [torch.where(act, o, p) for o, p in zip(other, k["ov"])]
    nb_imp = torch.zeros((4, n_nb))
    nb_vel = nb_other[3:6].clone()
    for k, act in zip(nbrs, has):
        lanes = k["lanes"][act[0]]
        nb_imp[:, lanes] = torch.cat([*k["nn"], *k["nt"]])[:, act[0]]
        nb_vel[:, lanes] = torch.cat(k["ov"])[:, act[0]]
    return torch.cat(pos), torch.cat(v), torch.cat([*ni, *ti]), nb_imp, nb_vel


@pytest.mark.parametrize("scene", ["segmented_ground", "bullet"])
def test_toi_substep_plain_equals_each_lane_in_turn(cpu_substeps, scene):
    """CPU lanes take the plain version (no launch, no "toi.substep_kernel"),
    which equals the passes in K8's order of work: the rank-by-rank loops
    the step ran inline are each lane's constraint and then its kept
    neighbors in slot order."""
    args, iterations = cpu_substeps[scene]
    kept = _kept(args)
    if scene == "segmented_ground":
        assert int(kept.max()) >= 4 and int((kept > 0).sum()) == 8     # ranks 0-3 and more
    else:
        assert int(kept.sum()) > 0 and bool((args[-1][3:6].abs() > 0).any())
    syncs = HostSyncs()
    with launched() as ran:
        got = ktoi.toi_substep_passes(*args, iterations=iterations, syncs=syncs)
    want = ktoi.toi_substep_passes_plain(*args, iterations=iterations)
    assert not ran
    assert "toi.substep_kernel" not in syncs.events
    assert syncs.count == 1          # the plain version's one read: the largest rank
    ref = _lane_order(args, iterations)
    for name, g, w, r in zip(("pose", "vel", "impulses", "nb_impulses", "nb_vel"),
                             got, want, ref):
        assert torch.equal(g, w), name
        assert torch.equal(g, r), name
    solved = args[0]
    assert bool((got[2][0:2, solved].sum(0) > 0).all())      # every solved lane pushed


def _substep_faulty(t, fault):
    """`t` with one fault, as `_faulty` makes them; a 1-D tensor that sets
    L or N gets a second axis for its shape."""
    if fault == "shape" and t.dim() == 1:
        return t[:, None]
    return _faulty(t, fault)


@pytest.mark.parametrize("fault", ["dtype", "shape", "device", "contiguous"])
def test_toi_substep_wrapper_checks_arguments(cpu_substeps, fault):
    """K8's wrapper refuses each malformed argument by its name before any
    launch."""
    args, iterations = cpu_substeps["bullet"]
    names = [name for name, _, _, _ in ktoi._SUBSTEP_ARGS]
    for i, name in enumerate(names):
        bad = list(args)
        bad[i] = _substep_faulty(args[i], fault)
        # the others' device is held against `solve`'s
        match = ("kind is on cpu, expected meta" if (fault, name) == ("device", "solve")
                 else f": {name} is on meta" if fault == "device" else f": {name} ")
        with pytest.raises(ValueError, match=match):
            ktoi.toi_substep_passes(*bad, iterations=iterations)
    with pytest.raises(ValueError, match="must not be negative"):
        ktoi.toi_substep_passes(*args, iterations=-1)
    with pytest.raises(ValueError, match="15 tensors expected"):
        ktoi.toi_substep_passes(*args[:-1], iterations=iterations)


@pytest.fixture(scope="module")
def card_substeps():
    """Sub-steps on the card: the segmented grounds, the bullet worlds, the
    segmented grounds without mini islands, chip_smoke.py's 4096 fast
    boxes at a thin wall, the busiest of 64 x sphere_stack(10)'s first 12
    steps (unit circles on an edge) and 512 worlds of fast circles (circle
    against circle, box and edge)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on a card")
    import chip_smoke
    solved = lambda call: int(call[0][0].sum())
    return {
        "segmented_ground": _substep_calls(_segmented_ground(64, "cuda"), 1)[0],
        "bullet": [c for c in _substep_calls(_bullet_beside_box(4, "cuda"), 3)
                   if int(_kept(c[0]).sum())][0],
        "no_neighbors": _substep_calls(_segmented_ground(64, "cuda"), 1,
                                       toi_neighbors=False)[0],
        "fast_boxes": _substep_calls(chip_smoke.fast_box_worlds(4096, "cuda"), 1)[0],
        "sphere_stack": max(_substep_calls(replicate(scenes.sphere_stack(10, device="cuda"),
                                                     64), 12), key=solved),
        "fast_circles": _substep_calls(_fast_circles(512), 1)[0],
    }


def _substep_case(args, n_lanes, solved, keep):
    """n_lanes lanes cut from a captured sub-step: lane j copies the j-th
    (cyclically) of its solved lanes with the first keep[j % len(keep)] of
    that lane's kept neighbors, solved where `solved` says (an unsolved
    lane keeps none); 16 more neighbors that no lane keeps follow."""
    lanes_in, _, _, _, _, _, _, span = args[:8]
    nb_in = args[8:]
    dev = lanes_in.device
    pick = torch.nonzero(lanes_in).flatten()
    src = pick[torch.arange(n_lanes, device=dev) % pick.numel()]
    solved = torch.as_tensor(solved, device=dev)
    keep = torch.as_tensor(keep, device=dev)[torch.arange(n_lanes, device=dev) % len(keep)]
    count = torch.where(solved, torch.minimum(keep, span[1, src].long()), 0)
    n_kept = int(count.sum())
    owner = torch.repeat_interleave(torch.arange(n_lanes, device=dev), count,
                                    output_size=n_kept)
    rank = (torch.arange(n_kept, device=dev)
            - torch.repeat_interleave(torch.cumsum(count, 0) - count, count,
                                      output_size=n_kept))
    old = nb_in[1].long()[span[0, src[owner]].long() + rank]
    old = torch.cat([old, torch.arange(16, device=dev) % nb_in[0].numel()])
    lane_rows = [t[..., src].contiguous() for t in args[1:7]]
    span_new = torch.stack([torch.cumsum(count, 0) - count, count]).to(torch.int32)
    parent = torch.cat([owner, torch.full((16,), -1, device=dev)]).to(torch.int32)
    order = torch.arange(n_kept + 16, device=dev, dtype=torch.int32)
    nb_rows = [t[..., old].contiguous() for t in nb_in[2:]]
    return (solved.contiguous(), *lane_rows, span_new.contiguous(), parent, order, *nb_rows)


SUBSTEP_SHAPES = {
    # (lanes, solved mask, kept neighbors a lane, cycled)
    "none_solved": (4096, lambda n: np.zeros(n, bool), [0]),
    "one_lane": (1, lambda n: np.ones(n, bool), [3]),
    "ragged": (1001, lambda n: np.arange(n) % 3 != 1, [0, 1, 2, 3, 4]),
    "all_solved": (8192, lambda n: np.ones(n, bool), [4, 0, 2]),
    "past_one_wave": (300_001, lambda n: np.arange(n) % 7 == 0, [1, 4, 0, 3]),
}


def _equal_to_plain(args, iterations):
    """K8 twice against the plain version: equal values everywhere, equal
    bits on the solved lanes and the kept neighbors."""
    want = ktoi.toi_substep_passes_plain(*args, iterations=iterations)
    on, kept = args[0], args[8] >= 0
    with launched() as ran:
        for _ in range(2):
            got = ktoi.toi_substep_passes(*args, iterations=iterations)
            torch.cuda.synchronize()
            for name, g, w, sel in zip(("pose", "vel", "impulses", "nb_impulses", "nb_vel"),
                                       got, want, (on, on, on, kept, kept)):
                assert torch.equal(g, w), name
                assert torch.equal(g[:, sel].view(torch.int32), w[:, sel].view(torch.int32)), name
    assert ran == {"toi_substep_launch": 2}
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("scene", ["segmented_ground", "bullet", "no_neighbors",
                                   "fast_boxes", "sphere_stack", "fast_circles"])
def test_toi_substep_kernel_matches_plain(card_substeps, scene):
    args, iterations = card_substeps[scene]
    kept = _kept(args)
    solve, kind, body = args[0], args[1], args[3]
    if scene == "no_neighbors":
        assert args[8].numel() == 0 and int(kept.max()) == 0
    elif scene == "sphere_stack":
        assert bool((body[9, solve] == 1.0).all())          # a unit circle on each lane
    elif scene == "fast_circles":
        assert int((kind[0, solve] == settings.MANIFOLD_CIRCLES).sum()) > 0
    elif scene != "fast_boxes":
        assert int(kept.max()) >= (4 if scene == "segmented_ground" else 1)
    got = _equal_to_plain(args, iterations)
    assert bool((got[2][0:2, solve].sum(0) > 0).any())      # the passes pushed


@pytest.mark.gpu
def test_toi_substep_kernel_matches_plain_on_shard_threads():
    """Two shards of 64 segmented grounds on one card, each stepped from
    its own thread on its own stream: every K8 launch there equals the
    plain version bit for bit, and the sharded step equals the unsharded
    one bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on a card")
    from box2d_mt_tpu_torch.parallel import sharding
    from box2d_mt_tpu_torch.world import possible_kinds
    dev = torch.device("cuda", torch.cuda.current_device())
    states = _segmented_ground(64, "cuda")
    kw = dict(max_colors=8, kinds=possible_kinds(states))
    step, shard = sharding.make_sharded_step([dev, dev], **kw)
    try:
        with _recording_substeps() as calls:
            got, _ = step(shard(states), DT)
    finally:
        step.close()
    with _recording_substeps() as whole:
        want, _ = step_batched(states, DT, **kw)
    torch.cuda.synchronize()
    assert len(calls) >= 2 and all(out is not None for _, _, out in calls)
    # each launch took one shard's lanes
    assert {args[0].numel() for args, _, _ in calls} == \
        {args[0].numel() // 2 for args, _, _ in whole}
    for args, iterations, out in calls:
        plain = ktoi.toi_substep_passes_plain(*args, iterations=iterations)
        for name, g, w in zip(("pose", "vel", "impulses", "nb_impulses", "nb_vel"),
                              out, plain):
            assert torch.equal(g.view(torch.int32), w.view(torch.int32)), name
    got = got.gather()
    for name in ("c", "a", "v", "w"):
        assert torch.equal(getattr(got.bodies, name), getattr(want.bodies, name)), name


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(SUBSTEP_SHAPES))
def test_toi_substep_kernel_matches_plain_at_every_launch_shape(card_substeps, case):
    args, iterations = card_substeps["segmented_ground"]
    n, solved, keep = SUBSTEP_SHAPES[case]
    cut = _substep_case(args, n, solved(n), keep)
    got = _equal_to_plain(cut, iterations)
    on = cut[0]
    # an unsolved lane without neighbors comes out as it went in
    assert torch.equal(got[0][:, ~on], cut[5][:, ~on])
    assert torch.equal(got[2][:, ~on], torch.zeros_like(got[2][:, ~on]))
    if bool(on.any()):
        assert set(_kept(cut)[on].tolist()) <= set(keep)
        assert bool((got[2][0:2, on].sum(0) > 0).any())
