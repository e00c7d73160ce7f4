"""The contact solve middle: velocity sweeps, integration, position sweeps.

Counterpart of `box2d_mt_tpu/ops/pallas_solve.py` (`solve_middle_pallas`,
kernel `_kernel` at :273-349): the contact-only part of b2Island::Solve
(b2Island.cpp:268-335) for a batch of worlds. Two implementations take
exactly the same arguments:

  * `solve_middle_plain`: PyTorch, color by color, modeled on the JAX
    package's XLA chunk path (world.py:702-848). It serves CPU tensors and
    is the reference the kernel is held against.
  * the CUDA kernel `csrc/solve_middle.cu`, one thread block per world.
    `solve_middle` launches it for CUDA tensors, and never falls back.

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

Semantics: within a color the lanes are conflict-free on dynamic bodies,
so a color is one parallel pass and only dynamic endpoints are written.
Color MC-1 is the overflow color of the coloring: its lanes may share
bodies, so it runs in chunks of CK lanes, each chunk reading the body
state at its start and applying its deltas in lane order (Jacobi per
chunk, the Pallas kernel's chunking).
"""

import ctypes

import torch

from .. import settings
from ..cuda_build import load
from .integrate import integrate_positions
from .solver import position_contact_math_s, velocity_contact_math_s

CK = 256
BLOB_ROWS = 51
AUX_ROWS = 5


def _check(blob, perm, color_start, dyn_ab, vel, pos, movable):
    nw, _, nc = blob.shape
    nb = vel.shape[-1]
    want = {"blob": (blob, torch.float32, (nw, BLOB_ROWS, nc)),
            "perm": (perm, torch.int32, (nw, nc)),
            "color_start": (color_start, torch.int32, (nw, color_start.shape[-1])),
            "dyn_ab": (dyn_ab, torch.uint8, (nw, nc)),
            "vel": (vel, torch.float32, (nw, 3, nb)),
            "pos": (pos, torch.float32, (nw, 3, nb)),
            "movable": (movable, torch.bool, (nw, nb))}
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"solve_middle: {name} must be {dtype} of shape "
                             f"{shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != blob.device:
            raise ValueError(f"solve_middle: {name} is on {t.device}, "
                             f"blob on {blob.device}")
        if not t.is_contiguous():
            raise ValueError(f"solve_middle: {name} must be contiguous")
    if color_start.shape[-1] < 2:
        raise ValueError("solve_middle: color_start needs max_colors + 1 >= 2 columns")


def solve_middle(blob, perm, color_start, dyn_ab, vel, pos, movable, dt: float,
                 velocity_iterations: int, position_iterations: int):
    """Run the solve middle: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors (see the module docstring)."""
    _check(blob, perm, color_start, dyn_ab, vel, pos, movable)
    if blob.device.type == "cpu":
        return solve_middle_plain(blob, perm, color_start, dyn_ab, vel, pos,
                                  movable, dt, velocity_iterations,
                                  position_iterations)
    if blob.device.type != "cuda":
        raise ValueError(f"solve_middle: no implementation for {blob.device}")
    return _launch(blob, perm, color_start, dyn_ab, vel, pos, movable, dt,
                   velocity_iterations, position_iterations)


solve_middle.launches = 0


def _launch(blob, perm, color_start, dyn_ab, vel, pos, movable, dt,
            velocity_iterations, position_iterations):
    nw, _, nc = blob.shape
    nb = vel.shape[-1]
    vel_out = torch.empty_like(vel)
    pos_out = torch.empty_like(pos)
    aux = torch.empty((nw, AUX_ROWS, nc), dtype=torch.float32, device=blob.device)
    scratch = torch.empty((nw, BLOB_ROWS + 1, nc), dtype=torch.float32,
                          device=blob.device)
    fn = _entry()
    stream = torch.cuda.current_stream(blob.device).cuda_stream
    with torch.cuda.device(blob.device):
        err = fn(blob.data_ptr(), perm.data_ptr(), color_start.data_ptr(),
                 dyn_ab.data_ptr(), vel.data_ptr(), pos.data_ptr(),
                 movable.data_ptr(), vel_out.data_ptr(), pos_out.data_ptr(),
                 aux.data_ptr(), scratch.data_ptr(), nw, nb, nc,
                 color_start.shape[-1] - 1, velocity_iterations,
                 position_iterations, float(dt), stream)
    if err != 0:
        raise RuntimeError(f"solve_middle kernel launch failed: CUDA error {err}")
    solve_middle.launches += 1
    return vel_out, pos_out, aux


def _entry():
    fn = load("solve_middle").solve_middle_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _packed_layout(perm, color_start, dyn_ab, n_colors):
    """Per packed position: slot, color, chunk (within the overflow
    color), dyn flags and whether the position is used."""
    nw, nc = perm.shape
    p = torch.arange(nc, device=perm.device)
    used = p < color_start[:, -1:]
    slot = torch.where(used, perm, 0).long()
    color = (p[None, None, :] >= color_start[:, 1:, None]).sum(1)    # (W, C)
    start = torch.gather(color_start, 1, color.clamp_max(n_colors - 1))
    chunk = torch.where(color == n_colors - 1, (p - start) // CK, 0)
    flags = torch.gather(dyn_ab, 1, slot)
    return slot, used, color, chunk, (flags & 1) > 0, (flags & 2) > 0


def _passes(color_start):
    """The (color, chunk) passes of one sweep in order. Reads the color
    sizes to the host once."""
    mc = color_start.shape[-1] - 1
    sizes = (color_start[:, 1:] - color_start[:, :-1]).amax(0).tolist()
    out = [(c, 0) for c in range(mc - 1) if sizes[c] > 0]
    out += [(mc - 1, k) for k in range(-(-sizes[mc - 1] // CK))]
    return out


def _apply(state, idx_a, idx_b, da, db):
    """state (W, 3, N+1) += deltas at body columns, lane by lane in order
    (A endpoint then B endpoint); column N is the discard column."""
    nw, _, nl = da.shape
    idx = torch.stack([idx_a, idx_b], -1).reshape(nw, 1, 2 * nl).expand(-1, 3, -1)
    state.scatter_add_(2, idx, torch.stack([da, db], -1).reshape(nw, 3, 2 * nl))


def solve_middle_plain(blob, perm, color_start, dyn_ab, vel, pos, movable,
                       dt: float, velocity_iterations: int,
                       position_iterations: int):
    """PyTorch solve middle (same arguments and results as the kernel)."""
    nw, _, nc = blob.shape
    nb = vel.shape[-1]
    mc = color_start.shape[-1] - 1
    slot, used, color, chunk, dyn_a, dyn_b = _packed_layout(
        perm, color_start, dyn_ab, mc)
    pb = torch.gather(blob, 2, slot[:, None, :].expand(-1, BLOB_ROWS, -1))
    r = lambda k: pb[:, k]                                    # (W, C) row
    act = used & (r(0) > 0.5)
    ia = r(1).long()
    ib = r(2).long()
    pc = r(3).to(torch.int32)
    imp = [pb[:, 47 + i].clone() for i in range(4)]          # ni0 ni1 ti0 ti1
    min_sep = torch.zeros_like(imp[0])
    passes = _passes(color_start)
    dump = torch.full_like(ia, nb)

    def lane_mask(c, k):
        return act & (color == c) & (chunk == k)

    def gather3(state, idx):
        g = torch.gather(state, 2, idx[:, None, :].expand(-1, 3, -1))
        return g[:, 0], g[:, 1], g[:, 2]

    vel_s = torch.cat([vel, vel.new_zeros(nw, 3, 1)], 2)
    for _ in range(velocity_iterations):
        for c, k in passes:
            m = lane_mask(c, k)
            vax0, vay0, wa0 = gather3(vel_s, ia)
            vbx0, vby0, wb0 = gather3(vel_s, ib)
            nis, tis, vax, vay, wa, vbx, vby, wb = velocity_contact_math_s(
                r(4), r(5), r(6), r(7), r(8), r(9), r(10), r(11),
                (r(12), r(14)), (r(13), r(15)), (r(16), r(18)), (r(17), r(19)),
                (r(20), r(21)), (r(22), r(23)), (r(24), r(25)),
                r(26), r(27), r(28), r(29), r(30), r(31), pc,
                (imp[0], imp[1]), (imp[2], imp[3]),
                vax0, vay0, wa0, vbx0, vby0, wb0, m)
            imp = [nis[0], nis[1], tis[0], tis[1]]
            da = torch.stack([vax - vax0, vay - vay0, wa - wa0], 1)
            db = torch.stack([vbx - vbx0, vby - vby0, wb - wb0], 1)
            _apply(vel_s, torch.where(m & dyn_a, ia, dump),
                   torch.where(m & dyn_b, ib, dump), da, db)

    v = vel_s[:, 0:2, :nb].transpose(1, 2)
    c_, a_, v, w = integrate_positions(pos[:, 0:2].transpose(1, 2), pos[:, 2],
                                       v, vel_s[:, 2, :nb], dt, movable)
    vel_out = torch.stack([v[..., 0], v[..., 1], w], 1)
    pos_s = torch.cat([torch.stack([c_[..., 0], c_[..., 1], a_], 1),
                       pos.new_zeros(nw, 3, 1)], 2)

    for _ in range(position_iterations):
        for c, k in passes:
            m = lane_mask(c, k)
            cax0, cay0, aa0 = gather3(pos_s, ia)
            cbx0, cby0, ab0 = gather3(pos_s, ib)
            cax, cay, aa, cbx, cby, ab, ms = position_contact_math_s(
                r(46).to(torch.int32), pc, r(6), r(7), r(8), r(9),
                r(40), r(41), r(42), r(43), r(44), r(45),
                r(38), r(39), r(36), r(37), (r(32), r(34)), (r(33), r(35)),
                cax0, cay0, aa0, cbx0, cby0, ab0, m,
                settings.BAUMGARTE, settings.MAX_LINEAR_CORRECTION)
            min_sep = torch.where(m, ms, min_sep)
            da = torch.stack([cax - cax0, cay - cay0, aa - aa0], 1)
            db = torch.stack([cbx - cbx0, cby - cby0, ab - ab0], 1)
            _apply(pos_s, torch.where(m & dyn_a, ia, dump),
                   torch.where(m & dyn_b, ib, dump), da, db)

    # impulses + min separation back to slot order
    rows = torch.stack(imp + [min_sep], 1)                    # (W, 5, C)
    aux = blob.new_zeros(nw, AUX_ROWS, nc + 1)
    dest = torch.where(used, slot, nc)
    aux.scatter_(2, dest[:, None, :].expand(-1, AUX_ROWS, -1), rows)
    return vel_out.contiguous(), pos_s[..., :nb].contiguous(), aux[..., :nc].contiguous()
