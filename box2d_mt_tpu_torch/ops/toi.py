"""Time of impact over lanes: the TOI phase's kernel.

Counterpart of `box2d_mt_tpu/ops/pallas_toi.py` (`time_of_impact_lanes`,
kernel `_kernel` at :48-531): conservative advancement (b2TimeOfImpact,
b2TimeOfImpact.cpp:256-497) for every candidate lane of a TOI round. Two
implementations take exactly the same arguments:

  * `time_of_impact_lanes_plain`: `ops.distance.time_of_impact` in
    PyTorch, modeled on the XLA path the JAX package runs on a CPU
    (world.py:1283-1289). It serves CPU tensors and is the reference the
    kernel is held against.
  * the CUDA kernel `csrc/toi.cu`, one thread per lane.
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

from ..cuda_build import load
from . import distance

SWEEP_ROWS = 8
NV = 8


def _check(verts_a, count_a, radius_a, sweep_a, verts_b, count_b, radius_b,
           sweep_b, t_max, active):
    n = active.shape[0] if active.dim() == 1 else -1
    want = {"verts_a": (verts_a, torch.float32, (2, NV, n)),
            "count_a": (count_a, torch.int32, (n,)),
            "radius_a": (radius_a, torch.float32, (n,)),
            "sweep_a": (sweep_a, torch.float32, (SWEEP_ROWS, n)),
            "verts_b": (verts_b, torch.float32, (2, NV, n)),
            "count_b": (count_b, torch.int32, (n,)),
            "radius_b": (radius_b, torch.float32, (n,)),
            "sweep_b": (sweep_b, torch.float32, (SWEEP_ROWS, n)),
            "t_max": (t_max, torch.float32, (n,)),
            "active": (active, torch.bool, (n,))}
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"time_of_impact_lanes: {name} must be {dtype} of "
                             f"shape {shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != active.device:
            raise ValueError(f"time_of_impact_lanes: {name} is on {t.device}, "
                             f"active on {active.device}")
        if not t.is_contiguous():
            raise ValueError(f"time_of_impact_lanes: {name} must be contiguous")


def time_of_impact_lanes(verts_a, count_a, radius_a, sweep_a,
                         verts_b, count_b, radius_b, sweep_b, t_max, active):
    """Time of impact per lane: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors (see the module docstring)."""
    args = (verts_a, count_a, radius_a, sweep_a, verts_b, count_b, radius_b,
            sweep_b, t_max, active)
    _check(*args)
    if active.device.type == "cpu":
        return time_of_impact_lanes_plain(*args)
    if active.device.type != "cuda":
        raise ValueError(f"time_of_impact_lanes: no implementation for {active.device}")
    return _launch(*args)


time_of_impact_lanes.launches = 0


def _launch(*args):
    active = args[-1]
    n = active.shape[0]
    state = torch.empty(n, dtype=torch.int32, device=active.device)
    t = torch.empty(n, dtype=torch.float32, device=active.device)
    fn = _entry()
    stream = torch.cuda.current_stream(active.device).cuda_stream
    with torch.cuda.device(active.device):
        err = fn(*(a.data_ptr() for a in args), state.data_ptr(), t.data_ptr(),
                 n, stream)
    if err != 0:
        raise RuntimeError(f"time_of_impact kernel launch failed: CUDA error {err}")
    time_of_impact_lanes.launches += 1
    return state, t


def _entry():
    fn = load("toi").toi_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


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
