"""The yardstick of the kernels' roofline shares: the card's peaks and
what each kernel's call must move and compute, counted from its inputs.

Frozen from the builders' smoke run (chip_smoke.py at commit a8cb7c2,
`HBM_BYTES_PER_S`, `F32_FLOP_PER_S`, `K1_OPS_VEL/POS`, `k1_bytes`,
`k2_bytes`, `bound`), so that a later change to the program cannot move
the yardstick. A call is described by `ArgInfo`s: each argument's shape
and element size, and its values where the count needs them."""

from typing import NamedTuple, Optional

# one NVIDIA H100 SXM (NVIDIA's data sheet): HBM rate and the float32
# rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# K1's float32 operations per solved lane: per velocity iteration and per
# position iteration, counted from csrc/solve_middle.cu (sinf and cosf as
# 20 operations each)
K1_OPS_VEL, K1_OPS_POS = 130, 260


class ArgInfo(NamedTuple):
    """One argument of a recorded call: its shape, bytes an element and,
    for arguments the counts read, its values (a host tensor)."""
    shape: tuple
    element_size: int
    values: Optional[object] = None

    @property
    def numel(self):
        n = 1
        for d in self.shape:
            n *= d
        return n


def bound_seconds(n_bytes, ops):
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the operations over the float32 peak."""
    return max(n_bytes / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S)


def k1_bytes(args):
    """Bytes K1 (solve_middle_kernel) must move for one call, each read or
    written once: the blob rows, perm and dyn_ab entries of the solved
    lanes (color_start[:, -1] a world), color_start, the body planes and the
    movable flags in; the body planes and the (W, 5, C) aux out."""
    blob, perm, color_start, dyn_ab, vel, pos, movable = args[:7]
    nw, rows, nc = blob.shape
    solved = int(color_start.values[:, -1].sum())
    planes = (vel.numel + pos.numel) * vel.element_size
    inputs = (solved * (rows * blob.element_size + perm.element_size + dyn_ab.element_size)
              + color_start.numel * color_start.element_size
              + planes + movable.numel * movable.element_size)
    return inputs + planes + nw * 5 * nc * blob.element_size


def k1_ops(args):
    """K1's float32 operations for one call: each solved lane, each
    velocity and each position iteration (args 8 and 9 of the call)."""
    solved = int(args[2].values[:, -1].sum())
    return solved * (args[8].values * K1_OPS_VEL + args[9].values * K1_OPS_POS)


def k2_bytes(args):
    """Bytes K2 (toi_kernel) must move for one call, each read or written
    once: `active`, `t_max`, the state and t of every lane; for an active
    lane also both counts, radii and sweep rows, and each proxy's own
    vertices (count x 2 floats, not the 8 slots). K2 is counted by bytes
    alone: its operations follow its loops' trips, which only the
    program's plain version reports."""
    va, ca, ra, sa, vb, cb, rb, sb, t_max, active = args
    n = active.shape[0]
    on = active.values.bool()
    n_on = int(on.sum())
    n_verts = int(ca.values[on].sum()) + int(cb.values[on].sum())
    every = n * (active.element_size + t_max.element_size + 4 + 4)
    per_on = 2 * (ca.element_size + ra.element_size + sa.shape[0] * sa.element_size)
    return every + n_on * per_on + n_verts * 2 * va.element_size
