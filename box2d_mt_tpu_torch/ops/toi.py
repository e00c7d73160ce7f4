"""Time of impact over lanes: the TOI phase's kernel.

Counterpart of `box2d_mt_tpu/ops/pallas_toi.py` (`time_of_impact_lanes`,
kernel `_kernel` at :48-531): conservative advancement (b2TimeOfImpact,
b2TimeOfImpact.cpp:256-497) for every candidate lane of a TOI round. Two
implementations take exactly the same arguments:

  * `time_of_impact_lanes_plain`: `ops.distance.time_of_impact` in
    PyTorch, modeled on the XLA path the JAX package runs on a CPU
    (world.py:1283-1289). It serves CPU tensors and is the reference the
    kernel is held against.
  * the CUDA kernel `csrc/toi.cu`: one launch, a block an SM, each block
    compacting the active lanes of its span of lanes in shared memory and
    solving them one a thread, 32 a warp.
    `time_of_impact_lanes` launches it for CUDA tensors, and never falls
    back.

Argument contract (all tensors contiguous, on one device; L lanes):

  verts_a, verts_b    (2, 8, L) f32  local vertices, plane-major:
                                     [x | y][vertex][lane]
  count_a, count_b    (L,) i32       vertex counts (1..8)
  radius_a, radius_b  (L,) f32       skin radii
  sweep_a, sweep_b    (8, L) f32     rows lc_x, lc_y, c0_x, c0_y, c_x, c_y,
                                     a0, a: local center and the sweep
                                     from (c0, a0) to (c, a), normalized
                                     to alpha0 = 0
  t_max               (L,) f32       end of the window (1.0 in the step)
  active              (L,) bool      a lane that is False returns
                                     (TOI_UNKNOWN, t_max) without work

Returns (state (L,) i32 of the `distance.TOI_*` codes, t (L,) f32).

The TPU layout (one 24-row f32 blob, lanes padded to 512) is gone: each
field is its own row of L values, so neighbouring threads read
neighbouring addresses.
"""

import ctypes

import torch

from ..cuda_build import call, entry
from . import distance

SWEEP_ROWS = 8
NV = 8
# each argument's name, dtype and leading dimensions (the last is L)
_ARGS = (("verts_a", torch.float32, (2, NV)), ("count_a", torch.int32, ()),
         ("radius_a", torch.float32, ()), ("sweep_a", torch.float32, (SWEEP_ROWS,)),
         ("verts_b", torch.float32, (2, NV)), ("count_b", torch.int32, ()),
         ("radius_b", torch.float32, ()), ("sweep_b", torch.float32, (SWEEP_ROWS,)),
         ("t_max", torch.float32, ()), ("active", torch.bool, ()))


def _check(args):
    active = args[-1]
    if active.dim() != 1:
        raise ValueError(f"time_of_impact_lanes: active must be {torch.bool} of shape "
                         f"(L,), got {active.dtype} {tuple(active.shape)}")
    n, device = active.shape[0], active.device
    for (name, dtype, lead), t in zip(_ARGS, args):
        if t.dtype != dtype or t.shape != (*lead, n):
            raise ValueError(f"time_of_impact_lanes: {name} must be {dtype} of "
                             f"shape {(*lead, n)}, got {t.dtype} {tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"time_of_impact_lanes: {name} is on {t.device}, "
                             f"active on {device}")
        if not t.is_contiguous():
            raise ValueError(f"time_of_impact_lanes: {name} must be contiguous")


def time_of_impact_lanes(verts_a, count_a, radius_a, sweep_a,
                         verts_b, count_b, radius_b, sweep_b, t_max, active):
    """Time of impact per lane: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors (see the module docstring)."""
    args = (verts_a, count_a, radius_a, sweep_a, verts_b, count_b, radius_b,
            sweep_b, t_max, active)
    _check(args)
    kind = active.device.type
    if kind == "cuda":
        return _launch(args)
    if kind == "cpu":
        return time_of_impact_lanes_plain(*args)
    raise ValueError(f"time_of_impact_lanes: no implementation for {active.device}")


def _launch(args):
    """One launch of csrc/toi.cu on PyTorch's current stream; raises when
    the launch is refused."""
    active = args[-1]
    device, n = active.device, active.shape[0]
    state = torch.empty(n, dtype=torch.int32, device=device)
    t = torch.empty(n, dtype=torch.float32, device=device)
    call("toi", "toi_launch", device, (*args, state, t), (n,))
    return state, t


def grid(n_lanes):
    """The kernel's grid for `n_lanes` lanes on the current card: (blocks,
    lanes a block). At most one block an SM, so one wave; each block
    compacts the active lanes of its span and solves them 32 a warp."""
    span = ctypes.c_int(0)
    blocks = entry("toi", "toi_grid", (ctypes.c_int, ctypes.POINTER(ctypes.c_int)))(
        n_lanes, ctypes.byref(span))
    return blocks, span.value


def time_of_impact_lanes_plain(verts_a, count_a, radius_a, sweep_a,
                               verts_b, count_b, radius_b, sweep_b, t_max,
                               active, stats=None):
    """PyTorch time of impact (same arguments and results as the kernel);
    `stats` as in `distance.time_of_impact`."""
    def proxy(verts, sweep):
        s = sweep.T
        return (verts.permute(2, 1, 0), s[:, 0:2], s[:, 2:4], s[:, 4:6],
                s[:, 6], s[:, 7])

    va, lca, c0a, ca, a0a, aa = proxy(verts_a, sweep_a)
    vb, lcb, c0b, cb, a0b, ab = proxy(verts_b, sweep_b)
    return distance.time_of_impact(
        va, count_a, radius_a, lca, c0a, ca, a0a, aa,
        vb, count_b, radius_b, lcb, c0b, cb, a0b, ab, t_max, active,
        stats=stats)
