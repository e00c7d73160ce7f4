"""Batched 2D math on tensors whose last axis is the 2-vector.

Equivalents of `box2d_mt_tpu.math2d` (reference: Box2D/Common/b2Math.h):
a rotation is a (..., 2) tensor of (sin, cos) and a transform is the pair
(p, q). Every operation keeps the JAX package's order of floating-point
operations so that the two packages agree to the last bits where the
underlying elementwise kernels do.
"""

import torch


def rot_from_angle(angle):
    """b2Rot::Set (b2Math.h:288-293): (..., 2) of (sin, cos)."""
    return torch.stack([torch.sin(angle), torch.cos(angle)], dim=-1)


def rot_vec(q, v):
    """b2Mul(q, v) (b2Math.h:451-454): rotate v by q."""
    s, c = q[..., 0], q[..., 1]
    x, y = v[..., 0], v[..., 1]
    return torch.stack([c * x - s * y, s * x + c * y], dim=-1)


def rot_t_vec(q, v):
    """b2MulT(q, v) (b2Math.h:457-460): inverse-rotate v by q."""
    s, c = q[..., 0], q[..., 1]
    x, y = v[..., 0], v[..., 1]
    return torch.stack([c * x + s * y, -s * x + c * y], dim=-1)


def dot(a, b):
    """b2Dot (b2Math.h:396)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]


def cross_vv(a, b):
    """b2Cross(a, b) (b2Math.h:402): scalar cross of two 2-vectors."""
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def cross_sv(s, v):
    """b2Cross(s, v) (b2Math.h:414-417)."""
    return torch.stack([-s * v[..., 1], s * v[..., 0]], dim=-1)


def normalize(v, eps=1.1754943508222875e-38):
    """b2Vec2::Normalize (b2Math.h:98-110): (unit, length); vectors shorter
    than `eps` normalize to zero."""
    ln = torch.sqrt(dot(v, v))
    small = ln < eps
    safe = torch.where(small, 1.0, ln)
    return torch.where(small[..., None], 0.0, v / safe[..., None]), ln


def sweep_get_transform(local_center, c0, c, a0, a, beta):
    """b2Sweep::GetTransform (b2Math.h:645-656): the transform at fraction
    beta between (c0, a0) and (c, a), shifted by the local center."""
    pos = (1.0 - beta)[..., None] * c0 + beta[..., None] * c
    angle = (1.0 - beta) * a0 + beta * a
    q = rot_from_angle(angle)
    return pos - rot_vec(q, local_center), q


def body_xf(c, a, local_center):
    """Body-origin transform (p, q) from the sweep center and angle."""
    q = rot_from_angle(a)
    return c - rot_vec(q, local_center), q


def take(x, idx):
    """Batched gather along the slot axis: x (W, M, ...), idx (W, K) with
    entries in [0, M) -> (W, K, ...)."""
    w = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[w, idx]


def add_at(flat, rows, values):
    """flat (R,) plus values (M,) at rows (M,), in place: the values of one
    row are added one after another, in the order they stand in `rows`,
    so every run and every world gets the same sums on every device. No
    one PyTorch call does that on both: on a CPU `index_add_` adds in that
    order, while `index_put_` with accumulate adds float tensors of 32768
    elements and more from several threads at once; on a card
    `index_put_` with accumulate sorts the rows stably and adds each run in
    order, while `index_add_` and `scatter_add_` add in no fixed order."""
    if flat.device.type == "cpu":
        return flat.index_add_(0, rows, values)
    return flat.index_put_((rows,), values, accumulate=True)


def add_rows(target, idx, delta):
    """target (W, N, K) + the sum of delta (W, M, K) rows at idx (W, M).
    The deltas are summed first (into zeros, in lane order: `add_at`) and
    then added, as the JAX package's scatter-add does; a row hit by one
    lane gets exactly its delta."""
    nw, n = target.shape[:2]
    k = target[0, 0].numel()
    rows = (idx.long() + n * torch.arange(nw, device=idx.device)[:, None])[..., None]
    rows = (rows * k + torch.arange(k, device=idx.device)).reshape(-1)
    acc = torch.zeros(target.numel(), dtype=target.dtype, device=target.device)
    add_at(acc, rows, delta.reshape(-1))
    return target + acc.reshape(target.shape)
