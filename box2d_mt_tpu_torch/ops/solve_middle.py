"""The contact solve middle: velocity sweeps, integration, position sweeps.

Counterpart of `box2d_mt_tpu/ops/pallas_solve.py` (`solve_middle_pallas`,
kernel `_kernel` at :273-349): the contact-only part of b2Island::Solve
(b2Island.cpp:268-335) for a batch of worlds. Two implementations take
exactly the same arguments:

  * `solve_middle_plain`: PyTorch, color by color, modeled on the JAX
    package's XLA chunk path (world.py:702-848). It serves CPU tensors and
    is the reference the kernel is held against.
  * the CUDA kernel `csrc/solve_middle.cu` (K1), a group of threads per
    world. `solve_middle` launches it for CUDA tensors, and never falls
    back.

Argument contract (all tensors contiguous, on one device):

  blob        (W, 51, C) f32  slot-order constraint rows (pack_cc_blob_t;
                              rows 47-50 are the warm-start impulses)
  perm        (W, C) i32      slot at each packed position; packed order
                              is color-major, slot order within a color
  color_start (W, MC+1) i32   offset of each color's lanes in packed
                              order; positions past color_start[:, MC]
                              are unused
  dyn_ab      (W, C) u8       slot order; bit 0 (1): body A is a dynamic
                              (conflict) endpoint, bit 1 (2): body B is
  vel         (W, 3, N) f32   rows vx, vy, w
  pos         (W, 3, N) f32   rows cx, cy, a
  movable     (W, N) bool     bodies that integrate (the solve mask)

Returns (vel_out (W, 3, N), pos_out (W, 3, N), aux (W, 5, C)) with aux
rows ni0, ni1, ti0, ti1, min_sep in slot order (0 for unused slots);
min_sep is min(0, separation) of the last position sweep.

Worlds with joints run the same work as four functions around the joint
passes, "the sandwich" (counterparts of `pack_packed`, `vel_iter_packed`,
`pos_iter_packed`, `unpack_packed`, pallas_solve.py:363-483), each a CUDA
kernel of `csrc/solve_middle.cu` for CUDA tensors and a plain version for
CPU tensors:

  pack_packed(blob, perm, color_start) -> packed (W, 52, C)
      rows 0-50 are the blob rows in packed order, row 51 is min_sep (0);
      positions past color_start[:, MC] are unspecified
  vel_iter_packed(packed, perm, color_start, dyn_ab, vel) -> vel'
      ONE velocity sweep; updates the impulse rows 47-50 of `packed` IN
      PLACE, so they persist from one call to the next
  pos_iter_packed(packed, perm, color_start, dyn_ab, pos) -> pos'
      ONE position sweep; writes the min_sep row of `packed` in place
  unpack_packed(packed, perm, color_start) -> aux (W, 5, C)

`solve_middle_plain` is the composition of the four plain versions with
`integrate_positions` between the velocity and the position sweeps.

K1 and the sweep kernels stage a world's rows of the packed table in
shared memory and give a world its own group of threads. K1 keeps a
world's whole table there for the call where it fits a block (the
resident path) and otherwise walks a global scratch table through a
ring of tiles, as the sweep kernels do. `middle_shape` picks K1's launch
shape, `sweep_shape` the sweeps' (threads a world, worlds a block, tile,
ring depth) and `unpack_shape` the unpack kernel's, from the static
shapes alone. A world whose body planes leave no room for a ring tile of
32 lanes in a block's shared memory (K1 above 4096 bodies or 16384 slots,
the sweeps above 8192 bodies) keeps its planes in global memory instead
(`global_planes`); every smaller world keeps the layout it had.

Semantics: within a color the lanes are conflict-free on dynamic bodies,
so a color is one parallel pass and only dynamic endpoints are written.
Color MC-1 is the overflow color of the coloring: its lanes may share
bodies, so it runs in chunks of CK lanes, each chunk reading the body
state at its start and applying its deltas in lane order (Jacobi per
chunk, the Pallas kernel's chunking).
"""

import functools
from typing import Callable, NamedTuple

import torch

from .. import cuda_build, settings
from ..cuda_build import need
from .integrate import integrate_positions
from .solver import position_contact_math_s, velocity_contact_math_s

CK = 256
BLOB_ROWS = 51
PACKED_ROWS = 52          # the blob rows and min_sep
MIN_SEP_ROW = 51
AUX_ROWS = 5


def _need_layout(fn, perm, color_start, dyn_ab, nw, nc, device):
    need(fn, "perm", perm, torch.int32, (nw, nc), device)
    if color_start.dim() != 2 or color_start.shape[1] < 2:
        raise ValueError(f"{fn}: color_start needs max_colors + 1 >= 2 columns")
    need(fn, "color_start", color_start, torch.int32, (nw, color_start.shape[1]), device)
    if dyn_ab is not None:
        need(fn, "dyn_ab", dyn_ab, torch.uint8, (nw, nc), device)


def _dispatch(fn, first, plain, launch, *args):
    """The plain version for CPU tensors, the kernel for CUDA tensors."""
    kind = first.device.type
    if kind == "cuda":
        return launch(*args)
    if kind == "cpu":
        return plain(*args)
    raise ValueError(f"{fn}: no implementation for {first.device}")


def solve_middle(blob, perm, color_start, dyn_ab, vel, pos, movable, dt: float,
                 velocity_iterations: int, position_iterations: int):
    """Run the solve middle: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors (see the module docstring)."""
    nw, _, nc = blob.shape
    nb = vel.shape[-1]
    dev = blob.device
    need("solve_middle", "blob", blob, torch.float32, (nw, BLOB_ROWS, nc), dev)
    _need_layout("solve_middle", perm, color_start, dyn_ab, nw, nc, dev)
    need("solve_middle", "vel", vel, torch.float32, (nw, 3, nb), dev)
    need("solve_middle", "pos", pos, torch.float32, (nw, 3, nb), dev)
    need("solve_middle", "movable", movable, torch.bool, (nw, nb), dev)
    return _dispatch("solve_middle", blob, solve_middle_plain, _launch,
                     blob, perm, color_start, dyn_ab, vel, pos, movable, dt,
                     velocity_iterations, position_iterations)


def _call(name, device, pointers, ints, dt=None):
    """Launch one kernel of csrc/solve_middle.cu (`cuda_build.call`), the
    time step `dt` after the ints where the entry takes one."""
    cuda_build.call("solve_middle", name, device, pointers, ints, () if dt is None else (dt,))


def _launch(blob, perm, color_start, dyn_ab, vel, pos, movable, dt,
            velocity_iterations, position_iterations):
    nw, _, nc = blob.shape
    nb, mc = vel.shape[-1], color_start.shape[-1] - 1
    shape = middle_shape(nb, nc, mc)
    _need_smem("solve_middle", shape.smem_bytes, nb, nc)
    vel_out = torch.empty_like(vel)
    pos_out = torch.empty_like(pos)
    aux = torch.empty((nw, AUX_ROWS, nc), dtype=torch.float32, device=blob.device)
    scratch = None if shape.resident else torch.empty(
        (nw, PACKED_ROWS, nc), dtype=torch.float32, device=blob.device)
    _call("solve_middle_launch", blob.device,
          (blob, perm, color_start, dyn_ab, vel, pos, movable, vel_out, pos_out,
           aux, scratch),
          (nw, nb, nc, mc, velocity_iterations, position_iterations,
           shape.threads_per_world, int(shape.resident), shape.tile, shape.n_buffers,
           int(shape.global_planes)), dt)
    return vel_out, pos_out, aux


# --------------------------------------------------------------------------
# the sandwich: one launch per contact iteration (worlds with joints)
# --------------------------------------------------------------------------


def pack_packed(blob, perm, color_start):
    """Slot-order constraint rows -> the color-major packed table."""
    nw, _, nc = blob.shape
    need("pack_packed", "blob", blob, torch.float32, (nw, BLOB_ROWS, nc), blob.device)
    _need_layout("pack_packed", perm, color_start, None, nw, nc, blob.device)
    return _dispatch("pack_packed", blob, pack_packed_plain, _launch_pack,
                     blob, perm, color_start)


def _launch_pack(blob, perm, color_start):
    nw, _, nc = blob.shape
    packed = torch.empty((nw, PACKED_ROWS, nc), dtype=torch.float32,
                         device=blob.device)
    _call("pack_packed_launch", blob.device, (blob, perm, color_start, packed),
          (nw, nc, color_start.shape[-1] - 1))
    return packed


class SweepShape(NamedTuple):
    """How a sweep kernel (K4, K5) lays a batch out on the card."""
    threads_per_world: int    # a multiple of 32; a world's own barrier width
    worlds_per_block: int
    tile: int                 # lanes of the packed table staged at a time
    n_buffers: int            # tiles in flight: the ring's depth
    smem_bytes: int           # dynamic shared memory a block
    global_planes: bool       # the body plane and flags in global memory


VEL_ROWS, POS_ROWS = 36, 23   # table rows a velocity / a position sweep reads
RESIDENT_ROWS = 37            # K1's resident table: the velocity rows and min_sep
SMEM_BLOCK_MAX = 232448       # shared memory a block may take on an H100
_SMEM_SHARE = SMEM_BLOCK_MAX // 2    # leave room for a second block on the SM


def _align16(x):
    return -(-x // 16) * 16


def _world_bytes(row_floats, planes, n_bodies, n_contacts, max_colors):
    """One world's shared memory in K1 or a sweep kernel (`WorldLayout`
    in csrc/solve_middle.cu): the staged rows, the overflow chunk's deltas
    and endpoints, the body planes (K1: two, and the movable flags),
    color_start, the dynamic-endpoint flags in packed order. No planes:
    the global-planes layout, with neither planes nor flags."""
    chunk = min(CK, -(-n_contacts // 32) * 32)
    return (_align16(4 * row_floats) + 8 * chunk * 4 + planes * _align16(12 * n_bodies)
            + (_align16(n_bodies) if planes > 1 else 0)
            + _align16(4 * (max_colors + 1)) + (_align16(n_contacts) if planes else 0))


def _sweep_world_bytes(rows, n_bodies, n_contacts, max_colors, tile, n_buffers,
                       global_planes=False):
    """A sweep kernel's world: `n_buffers` tiles of `rows` rows."""
    return _world_bytes(n_buffers * rows * tile, 0 if global_planes else 1, n_bodies,
                        n_contacts, max_colors)


def _middle_world_bytes(resident, n_bodies, n_contacts, max_colors, tile, n_buffers,
                        global_planes=False):
    """K1's world: 37 resident rows of `tile` lanes, or the ring's tiles
    of the velocity rows, which then hold perm's inverse (C ints) unless
    the planes are global."""
    ring = n_buffers * VEL_ROWS * tile
    rows = (RESIDENT_ROWS * tile if resident
            else ring if global_planes else max(ring, n_contacts))
    return _world_bytes(rows, 0 if global_planes else 2, n_bodies, n_contacts, max_colors)


def _need_smem(fn, smem_bytes, n_bodies, n_contacts):
    if smem_bytes > SMEM_BLOCK_MAX:
        raise ValueError(f"{fn}: a world of {n_bodies} bodies and {n_contacts} contact "
                         f"slots needs {smem_bytes} B of shared memory, above the "
                         f"card's {SMEM_BLOCK_MAX} B a block")


@functools.lru_cache(maxsize=64)
def sweep_shape(n_bodies, n_contacts, max_colors, rows=VEL_ROWS) -> SweepShape:
    """The launch shape of a sweep, from the static shapes alone (no device
    read). A tile holds min(CK, C) lanes (smaller tiles split more colors
    into more passes); a world with more slots than a tile gets a ring of
    two. A world gets C / 4 threads between one warp and CK: a color holds
    tens of lanes, but staging and the overflow apply use every thread.
    A block takes as many worlds (a power of two, at most 8) as fit CK
    threads and half an SM's shared memory. A world above a block's shared
    memory keeps its body plane in global memory."""
    tile = min(CK, -(-n_contacts // 32) * 32)
    n_buffers = 1 if n_contacts <= tile else 2
    tw = min(CK, max(32, -(-(n_contacts // 4) // 32) * 32))
    world = _sweep_world_bytes(rows, n_bodies, n_contacts, max_colors, tile, n_buffers)
    glob = world > SMEM_BLOCK_MAX
    if glob:
        world = _sweep_world_bytes(rows, n_bodies, n_contacts, max_colors, tile, n_buffers,
                                   True)
    wpb = 1
    while 2 * wpb <= 8 and 2 * wpb * tw <= CK and 2 * wpb * world <= _SMEM_SHARE:
        wpb *= 2
    return SweepShape(tw, wpb, tile, n_buffers, wpb * world, glob)


class MiddleShape(NamedTuple):
    """How K1 lays a batch out on the card: a block a world."""
    threads_per_world: int    # a multiple of 32
    resident: bool            # the whole table in shared memory for the call
    tile: int                 # resident: lanes a row (>= C); ring: a tile's lanes
    n_buffers: int            # ring: tiles in flight (resident: 1)
    smem_bytes: int           # dynamic shared memory a block (a world)
    global_planes: bool       # ring: the body planes and flags in global memory


@functools.lru_cache(maxsize=64)
def middle_shape(n_bodies, n_contacts, max_colors) -> MiddleShape:
    """K1's launch shape, from the static shapes alone (no device read).
    A world's table stays resident (37 rows of C lanes, C rounded up to 4)
    where the world fits a block's shared memory; otherwise it walks the
    ring in tiles of the velocity rows, two as wide as a block's shared
    memory allows (a color split at a tile border costs a pass). A world
    gets C / 2 threads between one warp and CK (the pack's and the
    unpack's copies spread over them; a pass needs about C / 10) and a
    block of its own: on the card, several worlds a block were slower.
    Where the ring's tiles would be narrower than 32 lanes or perm's
    inverse does not fit beside them, the body planes go to global memory
    and the tiles take what the planes left."""
    tw = min(CK, max(32, -(-(n_contacts // 2) // 32) * 32))
    cap = -(-n_contacts // 4) * 4
    world = _middle_world_bytes(True, n_bodies, n_contacts, max_colors, cap, 1)
    if world <= SMEM_BLOCK_MAX:
        return MiddleShape(tw, True, cap, 1, world, False)
    for glob in (False, True):
        rest = _world_bytes(0, 0 if glob else 2, n_bodies, n_contacts, max_colors)
        widest = (SMEM_BLOCK_MAX - rest) // (2 * VEL_ROWS * 4) // 32 * 32
        tile = min(widest, -(-n_contacts // 32) * 32)
        n_buffers = 1 if n_contacts <= tile else 2
        world = _middle_world_bytes(False, n_bodies, n_contacts, max_colors, tile,
                                    n_buffers, glob)
        if tile >= 32 and world <= SMEM_BLOCK_MAX:
            break
    return MiddleShape(tw, False, tile, n_buffers, world, glob)


N_SMS = 132                   # streaming multiprocessors of an H100


def unpack_shape(n_worlds, n_contacts):
    """K6's launch shape (worlds a block, blocks a world's five rows are
    spread over): a block writes 1024 slots of an aux row at 16 bytes a
    thread, so small worlds share a block (a power of two, at most 8);
    the rows are spread only as far as two blocks an SM need it, since
    every block rebuilds the inverse of perm."""
    wpb = 1
    while 2 * wpb <= 8 and 2 * wpb * n_contacts <= 4 * CK:
        wpb *= 2
    blocks = -(-n_worlds // wpb)
    return wpb, min(AUX_ROWS, -(-2 * N_SMS // blocks))


def _need_iter(fn, packed, perm, color_start, dyn_ab, body, body_name):
    nw, _, nc = packed.shape
    dev = packed.device
    need(fn, "packed", packed, torch.float32, (nw, PACKED_ROWS, nc), dev)
    _need_layout(fn, perm, color_start, dyn_ab, nw, nc, dev)
    need(fn, body_name, body, torch.float32, (nw, 3, body.shape[-1]), dev)


def _launch_iter(name, rows, packed, perm, color_start, dyn_ab, body):
    nw, _, nc = packed.shape
    nb, mc = body.shape[-1], color_start.shape[-1] - 1
    shape = sweep_shape(nb, nc, mc, rows)
    _need_smem(name, shape.smem_bytes, nb, nc)
    out = torch.empty_like(body)
    _call(name, packed.device, (packed, perm, color_start, dyn_ab, body, out),
          (nw, nb, nc, mc, *shape[:4], int(shape.global_planes)))
    return out


def vel_iter_packed(packed, perm, color_start, dyn_ab, vel):
    """One contact velocity sweep over all colors; `packed`'s impulse rows
    are updated in place."""
    _need_iter("vel_iter_packed", packed, perm, color_start, dyn_ab, vel, "vel")
    return _dispatch("vel_iter_packed", packed, vel_iter_packed_plain,
                     _launch_vel_iter, packed, perm, color_start, dyn_ab, vel)


def _launch_vel_iter(*args):
    return _launch_iter("vel_iter_packed_launch", VEL_ROWS, *args)


def pos_iter_packed(packed, perm, color_start, dyn_ab, pos):
    """One contact position sweep over all colors; `packed`'s min_sep row
    is written in place."""
    _need_iter("pos_iter_packed", packed, perm, color_start, dyn_ab, pos, "pos")
    return _dispatch("pos_iter_packed", packed, pos_iter_packed_plain,
                     _launch_pos_iter, packed, perm, color_start, dyn_ab, pos)


def _launch_pos_iter(*args):
    return _launch_iter("pos_iter_packed_launch", POS_ROWS, *args)


def unpack_packed(packed, perm, color_start):
    """Impulses and min_sep back to slot order, 0 where unsolved."""
    nw, _, nc = packed.shape
    need("unpack_packed", "packed", packed, torch.float32, (nw, PACKED_ROWS, nc),
         packed.device)
    _need_layout("unpack_packed", perm, color_start, None, nw, nc, packed.device)
    return _dispatch("unpack_packed", packed, unpack_packed_plain,
                     _launch_unpack, packed, perm, color_start)


def _launch_unpack(packed, perm, color_start):
    nw, _, nc = packed.shape
    aux = torch.empty((nw, AUX_ROWS, nc), dtype=torch.float32, device=packed.device)
    _call("unpack_packed_launch", packed.device, (packed, perm, color_start, aux),
          (nw, nc, color_start.shape[-1] - 1, *unpack_shape(nw, nc)))
    return aux


class Sandwich(NamedTuple):
    """The four functions `step_batched` runs around the joint passes."""
    pack: Callable
    vel_iter: Callable
    pos_iter: Callable
    unpack: Callable


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------


class _Layout(NamedTuple):
    """Per packed position: slot, whether it is used, color, chunk (within
    the overflow color) and the dynamic-endpoint flags; and the (color,
    chunk) passes of one sweep in order."""
    slot: torch.Tensor
    used: torch.Tensor
    color: torch.Tensor
    chunk: torch.Tensor
    dyn_a: torch.Tensor
    dyn_b: torch.Tensor
    passes: list


def _packed_layout(perm, color_start, dyn_ab=None) -> _Layout:
    """Reads the color sizes to the host once (for the passes)."""
    nw, nc = perm.shape
    mc = color_start.shape[-1] - 1
    p = torch.arange(nc, device=perm.device)
    used = p < color_start[:, -1:]
    slot = torch.where(used, perm, 0).long()
    color = (p[None, None, :] >= color_start[:, 1:, None]).sum(1)    # (W, C)
    start = torch.gather(color_start, 1, color.clamp_max(mc - 1))
    chunk = torch.where(color == mc - 1, (p - start) // CK, 0)
    if dyn_ab is None:
        dyn_a = dyn_b = None
    else:
        flags = torch.gather(dyn_ab, 1, slot)
        dyn_a, dyn_b = (flags & 1) > 0, (flags & 2) > 0
    sizes = (color_start[:, 1:] - color_start[:, :-1]).amax(0).tolist()
    passes = [(c, 0) for c in range(mc - 1) if sizes[c] > 0]
    passes += [(mc - 1, k) for k in range(-(-sizes[mc - 1] // CK))]
    return _Layout(slot, used, color, chunk, dyn_a, dyn_b, passes)


def _apply(state, idx_a, idx_b, da, db):
    """state (W, 3, N+1) += deltas at body columns, lane by lane in order
    (A endpoint then B endpoint), as the kernels apply an overflow chunk;
    column N is the discard column. On the CPU scatter_add_ sums in index
    order; on a card it sums a column's entries in no fixed order, so
    there each body takes its k-th delta in round k."""
    nw, _, nl = da.shape
    idx = torch.stack([idx_a, idx_b], -1).reshape(nw, 2 * nl)
    delta = torch.stack([da, db], -1).reshape(nw, 3, 2 * nl)
    if state.device.type == "cpu":
        state.scatter_add_(2, idx[:, None].expand(-1, 3, -1), delta)
    else:
        _apply_in_rounds(state, idx, delta)


def _apply_in_rounds(state, idx, delta):
    """`_apply` with a fixed order on any device: idx (W, M) columns, delta
    (W, 3, M); a column's k-th entry (in index order) is added in round k,
    so no round adds two entries to one column but the discard column.
    Reads the number of rounds to the host."""
    dump = state.shape[-1] - 1
    sidx, order = torch.sort(idx, dim=1, stable=True)
    first = torch.searchsorted(sidx, sidx)                    # start of each body's run
    rank = torch.empty_like(idx).scatter_(
        1, order, torch.arange(idx.shape[1], device=idx.device) - first)
    rank = torch.where(idx == dump, 0, rank)
    for k in range(int(rank.max()) + 1):
        on = rank == k
        state.scatter_add_(2, torch.where(on, idx, dump)[:, None].expand(-1, 3, -1),
                           torch.where(on[:, None], delta, 0.0))


def _gather3(state, idx):
    g = torch.gather(state, 2, idx[:, None, :].expand(-1, 3, -1))
    return g[:, 0], g[:, 1], g[:, 2]


def _pack(blob, lay: _Layout):
    nw, _, nc = blob.shape
    packed = blob.new_zeros(nw, PACKED_ROWS, nc)
    rows = torch.gather(blob, 2, lay.slot[:, None, :].expand(-1, BLOB_ROWS, -1))
    packed[:, :BLOB_ROWS] = torch.where(lay.used[:, None, :], rows, 0.0)
    return packed


def _sweep(packed, lay: _Layout, body, lane_fn):
    """One sweep of `lane_fn` over every pass; `body` is (W, 3, N)."""
    nw, _, nb = body.shape
    r = lambda k: packed[:, k]                                # (W, C) row
    act = lay.used & (r(0) > 0.5)
    ia = torch.where(lay.used, r(1), 0.0).long()
    ib = torch.where(lay.used, r(2), 0.0).long()
    dump = torch.full_like(ia, nb)
    state = torch.cat([body, body.new_zeros(nw, 3, 1)], 2)
    for c, k in lay.passes:
        m = act & (lay.color == c) & (lay.chunk == k)
        a0 = _gather3(state, ia)
        b0 = _gather3(state, ib)
        a1, b1 = lane_fn(r, m, a0, b0)
        _apply(state, torch.where(m & lay.dyn_a, ia, dump),
               torch.where(m & lay.dyn_b, ib, dump),
               torch.stack([x - y for x, y in zip(a1, a0)], 1),
               torch.stack([x - y for x, y in zip(b1, b0)], 1))
    return state[..., :nb].contiguous()


def _vel_sweep(packed, lay: _Layout, vel):
    def lane(r, m, a0, b0):
        nis, tis, *out = velocity_contact_math_s(
            r(4), r(5), r(6), r(7), r(8), r(9), r(10), r(11),
            (r(12), r(14)), (r(13), r(15)), (r(16), r(18)), (r(17), r(19)),
            (r(20), r(21)), (r(22), r(23)), (r(24), r(25)),
            r(26), r(27), r(28), r(29), r(30), r(31), r(3).to(torch.int32),
            (r(47), r(48)), (r(49), r(50)), *a0, *b0, m)
        packed[:, 47:51] = torch.stack([nis[0], nis[1], tis[0], tis[1]], 1)
        return out[:3], out[3:]

    return _sweep(packed, lay, vel, lane)


def _pos_sweep(packed, lay: _Layout, pos):
    def lane(r, m, a0, b0):
        *out, ms = position_contact_math_s(
            r(46).to(torch.int32), r(3).to(torch.int32), r(6), r(7), r(8), r(9),
            r(40), r(41), r(42), r(43), r(44), r(45),
            r(38), r(39), r(36), r(37), (r(32), r(34)), (r(33), r(35)),
            *a0, *b0, m, settings.BAUMGARTE, settings.MAX_LINEAR_CORRECTION)
        packed[:, MIN_SEP_ROW] = torch.where(m, ms, r(MIN_SEP_ROW))
        return out[:3], out[3:]

    return _sweep(packed, lay, pos, lane)


def _unpack(packed, lay: _Layout):
    nw, _, nc = packed.shape
    rows = packed[:, [47, 48, 49, 50, MIN_SEP_ROW]]           # (W, 5, C)
    aux = packed.new_zeros(nw, AUX_ROWS, nc + 1)
    dest = torch.where(lay.used, lay.slot, nc)
    aux.scatter_(2, dest[:, None, :].expand(-1, AUX_ROWS, -1), rows)
    return aux[..., :nc].contiguous()


def pack_packed_plain(blob, perm, color_start):
    """PyTorch `pack_packed`; unused positions come out 0."""
    return _pack(blob, _packed_layout(perm, color_start))


def vel_iter_packed_plain(packed, perm, color_start, dyn_ab, vel):
    return _vel_sweep(packed, _packed_layout(perm, color_start, dyn_ab), vel)


def pos_iter_packed_plain(packed, perm, color_start, dyn_ab, pos):
    return _pos_sweep(packed, _packed_layout(perm, color_start, dyn_ab), pos)


def unpack_packed_plain(packed, perm, color_start):
    return _unpack(packed, _packed_layout(perm, color_start))


SANDWICH = Sandwich(pack_packed, vel_iter_packed, pos_iter_packed, unpack_packed)
SANDWICH_PLAIN = Sandwich(pack_packed_plain, vel_iter_packed_plain,
                          pos_iter_packed_plain, unpack_packed_plain)


def solve_middle_plain(blob, perm, color_start, dyn_ab, vel, pos, movable,
                       dt: float, velocity_iterations: int,
                       position_iterations: int):
    """PyTorch solve middle (same arguments and results as the kernel):
    the four plain sandwich functions, composed over one layout."""
    lay = _packed_layout(perm, color_start, dyn_ab)
    packed = _pack(blob, lay)
    for _ in range(velocity_iterations):
        vel = _vel_sweep(packed, lay, vel)
    c, a, v, w = integrate_positions(pos[:, 0:2].transpose(1, 2), pos[:, 2],
                                     vel[:, 0:2].transpose(1, 2), vel[:, 2],
                                     dt, movable)
    vel = torch.stack([v[..., 0], v[..., 1], w], 1)
    pos = torch.stack([c[..., 0], c[..., 1], a], 1)
    for _ in range(position_iterations):
        pos = _pos_sweep(packed, lay, pos)
    return vel.contiguous(), pos.contiguous(), _unpack(packed, lay)
