"""Broad phase: tight/fat AABBs, move hysteresis, pair finding and
warm-start carry-over, batched over worlds.

Port of `box2d_mt_tpu.ops.broadphase` (reference: b2DynamicTree.cpp,
b2BroadPhase.h:211-267). Two pair finders with one output contract: the
pair table comes out in the JAX package's canonical sorted (fixture A,
fixture B) key order, bit for bit, with its overflow count. Worlds up to
GRID_THRESHOLD fixture slots take the dense all-pairs finder (with its
row-extraction capacity rules, K_ROW and HUB_CAP); larger ones the
uniform-grid hash (`find_pairs_grid`). Every finder takes the optional
contact-filter hook `filter_fn(states, fi, fj) -> bool`, consulted on
integer fixture-index tensors with a leading world axis on top of the
built-in filters (b2ContactFilter::ShouldCollide override,
b2WorldCallbacks.h:52-62).
"""

import torch

from .. import settings
from ..math2d import take
from .narrowphase import KIND_INVALID, contact_kind, needs_swap
from .sync import HostSyncs

# all-pairs serves worlds up to this fixture capacity (as in the JAX package)
GRID_THRESHOLD = 1024
# The grid that `find_pairs` runs: the JAX package's finder with its
# hash's high bits for the bucket (`spread`) and 128 slots a bucket. JAX
# keeps the low bits of its products, so a pile's cells crowd a few
# buckets, and its 32 slots drop bucket entries, and with them pairs, in
# every large scene: at build 632 entries and 813 of 8145 pairs at
# multithread_demo(2800), 275 entries at many_bodies(10000), 1 at tiles;
# even 128 slots dropped 8 in a many_bodies(10000) roll on the card.
# Where neither finder drops an entry, both give the all-pairs table.
GRID_CELL_SLOTS = 128
# world-chunk bound on the (W, F, F) pair masks and the grid's (W, M)
# candidates: ~16M elements per chunk
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


def _worlds(obj, sl):
    """The worlds `sl` of a dataclass of (W, ...) tensors."""
    return type(obj)(**{k: getattr(obj, k)[sl] for k in obj.__dataclass_fields__})


def _chunk_state(state, sl, whole: bool):
    """The worlds `sl` of a State (the State itself when `whole`): what a
    filter hook sees beside a chunk's index tensors."""
    if whole:
        return state
    from ..state import map_leaves
    return map_leaves(lambda t: t[sl], state)


def _vetoed(filter_fn, state, fi, fj, like):
    """filter_fn's answer, checked: a bool tensor that broadcasts to the
    candidates' shape `like`."""
    ok = filter_fn(state, fi, fj)
    try:
        fits = torch.broadcast_shapes(ok.shape, like.shape) == like.shape
    except (AttributeError, RuntimeError):
        fits = False
    if not (fits and torch.is_tensor(ok) and ok.dtype == torch.bool):
        raise ValueError(f"filter_fn must return a bool tensor broadcasting to "
                         f"{tuple(like.shape)}, got {getattr(ok, 'dtype', type(ok))} "
                         f"{tuple(getattr(ok, 'shape', ()))}")
    return like & ok


def _role_order(fx, i_sel, j_sel, valid):
    """(f_a, f_b): role ordering by shape type (narrowphase registration
    order), -1 where not valid."""
    swap = needs_swap(take(fx.shape_type, i_sel.long()),
                      take(fx.shape_type, j_sel.long()))
    f_a = torch.where(valid, torch.where(swap, j_sel, i_sel), -1)
    f_b = torch.where(valid, torch.where(swap, i_sel, j_sel), -1)
    return f_a, f_b


def find_pairs_allpairs(state, capacity: int, filter_fn=None):
    """Dense upper-triangular overlap test over fat AABBs + filtering.
    Returns (f_a, f_b) (W, capacity) role-ordered fixture indices in
    canonical sorted-key order (-1 = empty) and the overflow count (W,).
    `filter_fn` sees (states, fi, fj) with fi, fj (W, F, F) row and column
    fixture indices."""
    fx, bd = state.fixtures, state.bodies
    nw, nf = fx.body.shape
    step = max(1, _MASK_ELEMENTS // (nf * nf))
    jkeys = _forbidden_joint_keys(state.joints, nf)
    parts = []
    for w0 in range(0, nw, step):
        sl = slice(w0, w0 + step)
        mask = _pair_mask(_worlds(fx, sl), _worlds(bd, sl),
                          None if jkeys is None else jkeys[sl])
        if filter_fn is not None:
            ii = torch.arange(nf, device=mask.device)
            mask = _vetoed(filter_fn, _chunk_state(state, sl, step >= nw),
                           ii[None, :, None].expand(mask.shape),
                           ii[None, None, :].expand(mask.shape), mask)
        parts.append(_extract(mask, capacity))
    i_sel, j_sel, valid, overflow = (torch.cat(x) for x in zip(*parts))
    return (*_role_order(fx, i_sel, j_sel, valid), overflow)


def _pair_allowed_idx(fx, bodies, jkeys, fi, fj, state=None, filter_fn=None):
    """The all-pairs mask's rules on (W, M) candidate fixture indices (-1:
    none): different bodies, one of them dynamic, both enabled, no joint
    with collide_connected False between them, the category/mask/group
    filters, a registered contact kind, and the filter hook's answer on
    the clamped indices (`state`: the worlds it sees)."""
    nf = fx.capacity
    fic = fi.clamp(0, nf - 1).long()
    fjc = fj.clamp(0, nf - 1).long()
    bi = take(fx.body, fic)
    bj = take(fx.body, fjc)
    bic = bi.clamp_min(0).long()
    bjc = bj.clamp_min(0).long()
    ok = (fi >= 0) & (fj >= 0) & (bi >= 0) & (bj >= 0) & (bi != bj)
    ok &= take(bodies.is_dynamic, bic) | take(bodies.is_dynamic, bjc)
    ok &= take(bodies.enabled, bic) & take(bodies.enabled, bjc)
    if jkeys is not None:
        bkey = torch.minimum(bi, bj) * nf + torch.maximum(bi, bj)
        idx = torch.searchsorted(jkeys, bkey).clamp_max(jkeys.shape[1] - 1)
        ok &= torch.gather(jkeys, 1, idx) != bkey
    g = lambda x: (take(x, fic), take(x, fjc))
    ok &= should_collide_filters(*g(fx.filter_group), *g(fx.filter_category),
                                 *g(fx.filter_mask))
    ti, tj = g(fx.shape_type)
    swap = needs_swap(ti, tj)
    ok &= contact_kind(torch.where(swap, tj, ti),
                       torch.where(swap, ti, tj)) != KIND_INVALID
    if filter_fn is not None:
        ok = _vetoed(filter_fn, state, fic, fjc, ok)
    return ok


# the JAX package's 0x8da6b343 / 0xd8163841 spatial-hash primes as int32;
# the products are taken in int64, whose low 32 bits are the int32 ones
_HASH_X, _HASH_Y = -1918851261, -669632447


def _grid(fx, bodies, jkeys, capacity, cell_slots, large_cap, spread, state=None,
          filter_fn=None):
    """`find_pairs_grid` on a chunk of worlds: (i_sel, j_sel, valid,
    overflow), the arrays of `_extract`'s contract."""
    nw, nf = fx.body.shape
    dev = fx.body.device
    lo, hi, exists = fx.aabb_lo, fx.aabb_hi, fx.exists
    inf = float("inf")

    # cell size per world: 1.5x the median fat-AABB extent
    ext = torch.where(exists[..., None], hi - lo, 0.0)
    extent = torch.maximum(ext[..., 0], ext[..., 1])                 # (W, F)
    n_ex = exists.sum(1).clamp_min(1)
    sorted_ext = torch.sort(torch.where(exists, extent, inf), dim=1).values
    median = torch.gather(sorted_ext, 1, (n_ex // 2).clamp(0, nf - 1)[:, None])
    cell = torch.clamp_min(1.5 * torch.where(torch.isfinite(median), median, 1.0),
                           10.0 * settings.LINEAR_SLOP)              # (W, 1)
    is_large = exists & (extent > cell)
    is_small = exists & ~is_large

    # bucket table of the small fixtures, each covering <= 2x2 cells
    n_buckets = max(16, 1 << (2 * nf - 1).bit_length())
    c0 = torch.floor(lo / cell[..., None]).to(torch.int32)           # (W, F, 2)
    c1 = torch.floor(hi / cell[..., None]).to(torch.int32)
    cxs = torch.stack([c0[..., 0], c1[..., 0], c0[..., 0], c1[..., 0]], -1)
    cys = torch.stack([c0[..., 1], c0[..., 1], c1[..., 1], c1[..., 1]], -1)
    same_x = c1[..., 0] == c0[..., 0]
    same_y = c1[..., 1] == c0[..., 1]
    dup = torch.stack([torch.zeros_like(same_x), same_x, same_y, same_x | same_y], -1)
    h = (cxs.long() * _HASH_X) ^ (cys.long() * _HASH_Y)
    if spread:      # the 32-bit hash's high bits, which every bit of a cell reaches
        bkt = (h & 0xFFFFFFFF) >> (33 - n_buckets.bit_length())
    else:           # the JAX package's low bits
        bkt = h & (n_buckets - 1)
    # one entry per (fixture, bucket): two covered cells can share a bucket
    eon = is_small[..., None] & ~dup                                 # (W, F, 4)
    e = lambda k: eon[..., k]
    same = lambda j, k: bkt[..., j] == bkt[..., k]
    entry_on = eon & ~torch.stack([
        torch.zeros_like(same_x),
        e(0) & same(1, 0),
        (e(0) & same(2, 0)) | (e(1) & same(2, 1)),
        (e(0) & same(3, 0)) | (e(1) & same(3, 1)) | (e(2) & same(3, 2))], -1)
    ekey = torch.where(entry_on, bkt, n_buckets).reshape(nw, 4 * nf)
    sk, eorder = torch.sort(ekey, dim=1, stable=True)
    starts = torch.searchsorted(
        sk, torch.arange(n_buckets, device=dev).expand(nw, -1).contiguous())
    rank = (torch.arange(4 * nf, device=dev)
            - torch.gather(starts, 1, sk.clamp_max(n_buckets - 1)))
    filled = sk < n_buckets
    fill_ok = filled & (rank < cell_slots)
    bucket_drop = (filled & (rank >= cell_slots)).sum(1)
    slot = torch.where(fill_ok, sk * cell_slots + rank, n_buckets * cell_slots)
    table = torch.full((nw, n_buckets * cell_slots + 1), nf, dtype=torch.int64,
                       device=dev)
    table.scatter_(1, slot, torch.where(fill_ok, eorder // 4, nf))
    table = table[:, :-1].reshape(nw, n_buckets, cell_slots)

    # grid candidates: each small fixture queries its covered cells; a
    # pair is emitted once, by its lower fixture, from the cell holding
    # the min corner of the two AABBs' intersection
    g = take(table, bkt.reshape(nw, 4 * nf)).reshape(nw, nf, 4, cell_slots)
    gc = g.clamp_max(nf - 1)
    flat = gc.reshape(nw, -1)
    lo_g = take(lo, flat).reshape(nw, nf, 4, cell_slots, 2)
    hi_g = take(hi, flat).reshape(nw, nf, 4, cell_slots, 2)
    lo_s, hi_s = lo[:, :, None, None], hi[:, :, None, None]
    ov = torch.all((lo_s <= hi_g) & (lo_g <= hi_s), -1)
    icell = torch.floor(torch.maximum(lo_s, lo_g) / cell[..., None, None, None]
                        ).to(torch.int32)
    own_cell = (icell[..., 0] == cxs[..., None]) & (icell[..., 1] == cys[..., None])
    f_self = torch.arange(nf, device=dev)
    cand_on = ((g < nf) & is_small[..., None, None] & ~dup[..., None] & ov
               & (f_self[:, None, None] < g) & own_cell)
    grid_i = f_self[:, None, None].expand(nw, nf, 4, cell_slots).reshape(nw, -1)
    grid_j = flat

    # the large fixtures (at most large_cap, the largest first, ties to the
    # lower index as jax.lax.top_k) pair densely against everyone
    large_cap = min(large_cap, nf)
    neg = torch.where(is_large, extent, -inf)
    lidx = torch.sort(neg, dim=1, descending=True, stable=True).indices[:, :large_cap]
    lvalid = torch.gather(is_large, 1, lidx)
    large_drop = (is_large.sum(1) - large_cap).clamp_min(0)
    li = lidx[..., None].expand(nw, large_cap, nf)
    lj = f_self.expand(nw, large_cap, nf)
    lo_l, hi_l = take(lo, lidx)[:, :, None], take(hi, lidx)[:, :, None]
    lov = torch.all((lo_l <= hi[:, None]) & (lo[:, None] <= hi_l), -1)
    # a large-large pair sits in both rows: keep the li < lj one
    ll_once = torch.where(is_large[:, None, :], li < lj, True)
    l_ok = lvalid[..., None] & exists[:, None, :] & lov & (li != lj) & ll_once

    cand_i = torch.cat([grid_i, torch.minimum(li, lj).reshape(nw, -1)], 1)
    cand_j = torch.cat([grid_j, torch.maximum(li, lj).reshape(nw, -1)], 1)
    cand_ok = torch.cat([cand_on.reshape(nw, -1), l_ok.reshape(nw, -1)], 1)
    cand_ok &= _pair_allowed_idx(fx, bodies, jkeys,
                                 torch.where(cand_ok, cand_i, -1).to(torch.int32),
                                 torch.where(cand_ok, cand_j, -1).to(torch.int32),
                                 state, filter_fn)

    # canonical sorted keys; a pair found twice (two covered cells of one
    # fixture in one bucket) is kept once
    big = nf * nf
    skey = torch.sort(torch.where(cand_ok, cand_i * nf + cand_j, big), dim=1).values
    again = torch.cat([torch.zeros_like(skey[:, :1], dtype=torch.bool),
                       (skey[:, 1:] == skey[:, :-1]) & (skey[:, 1:] < big)], 1)
    skey = torch.sort(torch.where(again, big, skey), dim=1).values
    n_found = (skey < big).sum(1)
    pick = skey[:, :capacity]
    if pick.shape[1] < capacity:
        pick = torch.cat([pick, pick.new_full((nw, capacity - pick.shape[1]), big)], 1)
    valid = pick < big
    pidx = torch.where(valid, pick, 0)
    overflow = (n_found - capacity).clamp_min(0) + bucket_drop + large_drop
    return ((pidx // nf).to(torch.int32), (pidx % nf).to(torch.int32), valid,
            overflow.to(torch.int32))


def find_pairs_grid(state, capacity: int, cell_slots: int = 32, large_cap: int = 16,
                    spread: bool = False, filter_fn=None, syncs: HostSyncs = None):
    """Uniform-grid-hash pair finder for large worlds (the JAX package's
    `find_pairs_grid`, the analog of b2DynamicTreeOfTrees' sparse grid of
    sub-trees, Box2D/MT/b2DynamicTreeOfTrees.h:30-46), batched over worlds:
    O(F * cell_slots) candidates a world instead of the dense F^2 mask, and
    the all-pairs finder's output contract.

    A world's cell is 1.5x its median fat-AABB extent; fixtures larger than
    a cell (grounds, walls; at most `large_cap`) pair with every fixture;
    each small fixture covers <= 2x2 cells, hashed into next_pow2(2F)
    buckets of `cell_slots` slots (by the hash's low bits as in the JAX
    package, or its high bits with `spread`). Dropped bucket entries and
    large fixtures are counted in the overflow. `filter_fn` sees (states,
    fi, fj) with fi, fj (W, M) candidate fixture indices. No host read; a
    call is the event "pairs.grid" in `syncs`."""
    if syncs is not None:
        syncs.event("pairs.grid")
    fx, bd = state.fixtures, state.bodies
    nw, nf = fx.body.shape
    per_world = nf * 4 * cell_slots + min(large_cap, nf) * nf
    step = max(1, _MASK_ELEMENTS // per_world)
    jkeys = _forbidden_joint_keys(state.joints, nf)
    parts = [_grid(_worlds(fx, sl), _worlds(bd, sl),
                   None if jkeys is None else jkeys[sl], capacity, cell_slots,
                   large_cap, spread, _chunk_state(state, sl, step >= nw), filter_fn)
             for sl in (slice(w0, w0 + step) for w0 in range(0, nw, step))]
    i_sel, j_sel, valid, overflow = (torch.cat(x) for x in zip(*parts))
    return (*_role_order(fx, i_sel, j_sel, valid), overflow)


def find_pairs(state, capacity: int, filter_fn=None, syncs: HostSyncs = None):
    """Strategy dispatch on the static fixture capacity, as in the JAX
    package: all-pairs up to GRID_THRESHOLD slots, the grid hash above,
    here spread over its buckets with GRID_CELL_SLOTS slots each. Both
    consult the optional `filter_fn` contact-filter hook; the grid's calls
    are counted in `syncs`."""
    if state.fixtures.capacity <= GRID_THRESHOLD:
        return find_pairs_allpairs(state, capacity, filter_fn)
    return find_pairs_grid(state, capacity, cell_slots=GRID_CELL_SLOTS, spread=True,
                           filter_fn=filter_fn, syncs=syncs)


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
