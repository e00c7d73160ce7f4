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


def add_rows(target, idx, delta):
    """target (W, N, K) + the sum of delta (W, M, K) rows at idx (W, M).
    The deltas are summed first (into zeros, in lane order: index_put_
    with accumulate is sequential on a CPU and sort-based, so ordered and
    deterministic, on a card) and then added, as the JAX package's
    scatter-add does; a row hit by one lane gets exactly its delta."""
    nw, n = target.shape[:2]
    rows = (idx.long() + n * torch.arange(nw, device=idx.device)[:, None]).reshape(-1)
    acc = torch.zeros((nw * n,) + target.shape[2:], dtype=target.dtype,
                      device=target.device)
    acc.index_put_((rows,), delta.reshape((-1,) + target.shape[2:]), accumulate=True)
    return target + acc.reshape(target.shape)
