"""Broad phase: tight/fat AABBs, move hysteresis, all-pairs pair finding and
warm-start carry-over, batched over worlds.

Port of `box2d_mt_tpu.ops.broadphase` (reference: b2DynamicTree.cpp,
b2BroadPhase.h:211-267). The pair table comes out in the same canonical
sorted (fixture A, fixture B) key order as the JAX package, bit for bit,
including its row-extraction capacity rules (K_ROW, HUB_CAP), so the
overflow counts agree too. Only the dense all-pairs finder is ported; a
world above GRID_THRESHOLD fixtures raises until the grid finder is.
"""

import torch

from .. import settings
from ..math2d import take
from .narrowphase import KIND_INVALID, contact_kind, needs_swap

# all-pairs serves worlds up to this fixture capacity (as in the JAX package)
GRID_THRESHOLD = 1024
# world-chunk bound on the (W, F, F) pair masks: ~16M elements per chunk
_MASK_ELEMENTS = 1 << 24


def tight_aabbs(fx, p, q):
    """Per-fixture tight AABB at per-fixture transforms p, q (W, F, 2)
    (b2Shape::ComputeAABB)."""
    vx = fx.verts[..., 0]                                   # (W, F, 8)
    vy = fx.verts[..., 1]
    qs, qc = q[..., 0:1], q[..., 1:2]
    wx = qc * vx - qs * vy + p[..., 0:1]
    wy = qs * vx + qc * vy + p[..., 1:2]
    valid = (torch.arange(settings.MAX_POLYGON_VERTICES, device=vx.device)
             < fx.nverts[..., None])
    inf = float("inf")
    lox = torch.where(valid, wx, inf).amin(-1) - fx.radius
    loy = torch.where(valid, wy, inf).amin(-1) - fx.radius
    hix = torch.where(valid, wx, -inf).amax(-1) + fx.radius
    hiy = torch.where(valid, wy, -inf).amax(-1) + fx.radius
    return torch.stack([lox, loy], -1), torch.stack([hix, hiy], -1)


def synchronize(fx, p0, q0, p1, q1):
    """b2Fixture::Synchronize + b2DynamicTree::MoveProxy: swept AABB over
    (xf0, xf1); re-fatten when it escapes the stored fat AABB. Returns
    (aabb_lo, aabb_hi, moved)."""
    lo0, hi0 = tight_aabbs(fx, p0, q0)
    lo1, hi1 = tight_aabbs(fx, p1, q1)
    lo = torch.minimum(lo0, lo1)
    hi = torch.maximum(hi0, hi1)
    disp = 0.5 * (hi1 + lo1) - 0.5 * (hi0 + lo0)
    contained = torch.all((fx.aabb_lo <= lo) & (hi <= fx.aabb_hi), dim=-1)
    d = settings.AABB_MULTIPLIER * disp
    new_lo = lo - settings.AABB_EXTENSION + torch.clamp_max(d, 0.0)
    new_hi = hi + settings.AABB_EXTENSION + torch.clamp_min(d, 0.0)
    moved = ~contained & fx.exists
    aabb_lo = torch.where(moved[..., None], new_lo, fx.aabb_lo)
    aabb_hi = torch.where(moved[..., None], new_hi, fx.aabb_hi)
    return aabb_lo, aabb_hi, moved


def initial_fat_aabbs(fx, p, q):
    """Fat AABBs at fixture creation (b2DynamicTree::CreateProxy)."""
    lo, hi = tight_aabbs(fx, p, q)
    return lo - settings.AABB_EXTENSION, hi + settings.AABB_EXTENSION


def should_collide_filters(group_i, group_j, cat_i, cat_j, mask_i, mask_j):
    """b2ContactFilter::ShouldCollide default implementation: group
    overrides category/mask."""
    same_group = (group_i == group_j) & (group_i != 0)
    group_ok = group_i > 0
    mask_ok = ((cat_i & mask_j) != 0) & ((cat_j & mask_i) != 0)
    return torch.where(same_group, group_ok, mask_ok)


def _forbidden_joint_keys(joints, nf: int):
    """(W, J) sorted packed body-pair keys of the active joints with
    collide_connected == False (b2Body::ShouldCollide walks the joint
    list); -2 fills the other slots. The key is lo * nf + hi in int32, as
    in the JAX package, which leaves the mouse block out of this walk."""
    from ..joints import blocks
    keys = []
    for name, block in blocks(joints):
        if name == "mouse":
            continue
        lo = torch.minimum(block.body_a, block.body_b)
        hi = torch.maximum(block.body_a, block.body_b)
        keys.append(torch.where(block.active & ~block.collide_connected,
                                lo * nf + hi, -2))
    if not keys:
        return None
    return torch.sort(torch.cat(keys, 1), dim=1).values


def _pair_mask(fx, bodies, jkeys):
    """(W, F, F) admissible overlapping pairs in the upper triangle;
    `jkeys` are the worlds' forbidden joint keys (or None)."""
    nf = fx.capacity
    lo, hi = fx.aabb_lo, fx.aabb_hi
    overlap = torch.all((lo[:, :, None, :] <= hi[:, None, :, :])
                        & (lo[:, None, :, :] <= hi[:, :, None, :]), dim=-1)
    ii = torch.arange(nf, device=lo.device)
    ok = overlap & (ii[:, None] < ii[None, :])
    ok &= fx.exists[:, :, None] & fx.exists[:, None, :]
    body = fx.body
    ok &= body[:, :, None] != body[:, None, :]
    bc = body.clamp_min(0)
    # b2Body::ShouldCollide: at least one dynamic body; enabled bodies only
    dyn = take(bodies.is_dynamic, bc) & (body >= 0)
    ok &= dyn[:, :, None] | dyn[:, None, :]
    enb = take(bodies.enabled, bc)
    ok &= enb[:, :, None] & enb[:, None, :]
    if jkeys is not None:
        # jointed bodies with collide_connected=False do not collide
        bkey = (torch.minimum(body[:, :, None], body[:, None, :]) * nf
                + torch.maximum(body[:, :, None], body[:, None, :]))
        flat = bkey.reshape(bkey.shape[0], -1)
        idx = torch.searchsorted(jkeys, flat).clamp_max(jkeys.shape[1] - 1)
        ok &= (torch.gather(jkeys, 1, idx) != flat).reshape(bkey.shape)
    ok &= should_collide_filters(
        fx.filter_group[:, :, None], fx.filter_group[:, None, :],
        fx.filter_category[:, :, None], fx.filter_category[:, None, :],
        fx.filter_mask[:, :, None], fx.filter_mask[:, None, :])
    # edge-edge (and any unregistered kind): no contact is ever created
    ti = fx.shape_type[:, :, None]
    tj = fx.shape_type[:, None, :]
    swap = needs_swap(ti, tj)
    ok &= contact_kind(torch.where(swap, tj, ti),
                       torch.where(swap, ti, tj)) != KIND_INVALID
    return ok


def _extract(pair_ok, capacity: int):
    """Canonical sorted-key extraction with the JAX package's capacity
    rules: rows with more than K_ROW pairs are "hubs", only the first
    HUB_CAP hub rows are extracted; everything past `capacity` keys is
    counted in the overflow. Returns (i_sel, j_sel, valid, overflow)."""
    w, nf, _ = pair_ok.shape
    k_row = 16 if nf >= 512 else min(64, nf)
    hub_cap = 8 if nf >= 512 else min(16, nf)
    row_cnt = pair_ok.sum(-1)                                  # (W, F)
    hub = row_cnt > k_row
    hub_rank = torch.cumsum(hub, dim=1, dtype=torch.int32) - 1
    kept_row = ~hub | (hub_rank < hub_cap)
    dropped = torch.where(hub & ~kept_row, row_cnt, 0).sum(-1)
    n_found = row_cnt.sum(-1)
    flat = (pair_ok & kept_row[:, :, None]).reshape(w, nf * nf)
    pos = torch.cumsum(flat, dim=1, dtype=torch.int32) - 1
    sel = flat & (pos < capacity)
    keys = torch.arange(nf * nf, device=flat.device, dtype=torch.int64)
    out = torch.full((w, capacity + 1), nf * nf, dtype=torch.int64,
                     device=flat.device)
    out.scatter_(1, torch.where(sel, pos, capacity).to(torch.int64),
                 keys.expand(w, -1))
    skey = out[:, :capacity]
    valid = skey < nf * nf
    pidx = torch.where(valid, skey, 0)
    overflow = torch.clamp_min(n_found - dropped - capacity, 0) + dropped
    return ((pidx // nf).to(torch.int32), (pidx % nf).to(torch.int32),
            valid, overflow.to(torch.int32))


def find_pairs_allpairs(state, capacity: int):
    """Dense upper-triangular overlap test over fat AABBs + filtering.
    Returns (f_a, f_b) (W, capacity) role-ordered fixture indices in
    canonical sorted-key order (-1 = empty) and the overflow count (W,)."""
    fx, bd = state.fixtures, state.bodies
    nw, nf = fx.body.shape
    step = max(1, _MASK_ELEMENTS // (nf * nf))
    jkeys = _forbidden_joint_keys(state.joints, nf)
    parts = []
    for w0 in range(0, nw, step):
        sl = slice(w0, w0 + step)
        fx_c = type(fx)(**{k: getattr(fx, k)[sl]
                           for k in fx.__dataclass_fields__})
        bd_c = type(bd)(**{k: getattr(bd, k)[sl]
                           for k in bd.__dataclass_fields__})
        parts.append(_extract(
            _pair_mask(fx_c, bd_c, None if jkeys is None else jkeys[sl]), capacity))
    i_sel, j_sel, valid, overflow = (torch.cat(x) for x in zip(*parts))
    # role ordering by shape type (narrowphase registration order)
    swap = needs_swap(take(fx.shape_type, i_sel.long()),
                      take(fx.shape_type, j_sel.long()))
    f_a = torch.where(valid, torch.where(swap, j_sel, i_sel), -1)
    f_b = torch.where(valid, torch.where(swap, i_sel, j_sel), -1)
    return f_a, f_b, overflow


def find_pairs(state, capacity: int):
    """Strategy dispatch; only the all-pairs finder is ported."""
    if state.fixtures.capacity > GRID_THRESHOLD:
        raise NotImplementedError(
            f"fixture capacity {state.fixtures.capacity} needs the grid pair "
            f"finder (above {GRID_THRESHOLD}), which is not ported yet")
    return find_pairs_allpairs(state, capacity)


def carry_over_contacts(old, f_a, f_b, nf: int):
    """Transfer manifold + impulses from the old contact table to the new
    pair list by canonical key matching; new pairs start cold."""
    big = torch.iinfo(torch.int64).max

    def key(fa, fb):
        lo = torch.minimum(fa, fb).to(torch.int64)
        hi = torch.maximum(fa, fb).to(torch.int64)
        return torch.where(fa >= 0, lo * nf + hi, big)

    old_key = key(old.f_a, old.f_b)
    new_key = key(f_a, f_b)
    skey, perm = torch.sort(old_key, dim=1, stable=True)
    pos = torch.searchsorted(skey, new_key).clamp_max(skey.shape[1] - 1)
    hit = (torch.gather(skey, 1, pos) == new_key) & (new_key != big)
    rows = torch.gather(perm, 1, pos)

    def move(x, fill=0):
        g = take(x, rows)
        h = hit.reshape(hit.shape + (1,) * (g.dim() - 2))
        return torch.where(h, g, torch.as_tensor(fill, dtype=x.dtype,
                                                 device=x.device))

    return type(old)(
        f_a=f_a.to(torch.int32), f_b=f_b.to(torch.int32),
        m_type=move(old.m_type), m_local_point=move(old.m_local_point),
        m_local_normal=move(old.m_local_normal), m_points=move(old.m_points),
        m_ids=move(old.m_ids), m_count=move(old.m_count),
        normal_impulse=move(old.normal_impulse),
        tangent_impulse=move(old.tangent_impulse),
        touching=move(old.touching, False),
        toi_count=torch.zeros_like(f_a, dtype=torch.int32),
        tangent_speed=move(old.tangent_speed),
        friction_override=move(old.friction_override, -1.0),
        restitution_override=move(old.restitution_override, -1.0))
