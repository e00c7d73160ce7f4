"""Observability + checkpoint/resume, over a batch of worlds.

Port of `box2d_mt_tpu.diagnostics`. The reference exposes world counts
(b2World.h:186-196), tree-quality metrics and a code-emitting
b2World::Dump (b2World.h:246-248). The state is one tree of tensors, so a
checkpoint is a direct serialization and counts are mask sums.

Checkpoints are numpy npz files without pickle whose leaves follow the
JAX package's `tree_flatten` order of the State fields, so that a
checkpoint written by the JAX package loads into the port through
`load_state(path, like)` (a single-world JAX state gains the world axis
of `like`).
"""

import dataclasses

import numpy as np
import torch

from . import settings
from .state import JOINT_BLOCKS, State


def counts(state: State) -> dict:
    """b2World::GetBodyCount/GetContactCount/GetJointCount analog: (W,)
    numpy arrays, one count per world."""
    b, c = state.bodies, state.contacts
    host = lambda t: t.sum(-1).cpu().numpy()
    out = {"bodies": host(b.body_type >= 0),
           "awake": host((b.body_type >= 0) & b.awake),
           "fixtures": host(state.fixtures.body >= 0),
           "contacts": host(c.f_a >= 0),
           "touching": host(c.touching)}
    joints = np.zeros(state.n_worlds, np.int64)
    for name, _ in JOINT_BLOCKS:
        blk = getattr(state.joints, name)
        if blk.body_a.shape[-1]:
            joints = joints + host(blk.active)
    out["joints"] = joints
    return out


def _leaves(obj):
    """The tensors of a State in the JAX package's tree_flatten order: the
    dataclass fields in declaration order, depth first."""
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            yield from _leaves(v)
        else:
            yield v


def _rebuild(like, it):
    return type(like)(**{f.name: (_rebuild(getattr(like, f.name), it)
                                  if dataclasses.is_dataclass(getattr(like, f.name))
                                  else next(it))
                         for f in dataclasses.fields(like)})


def save_state(state: State, path) -> None:
    """Checkpoint the whole batched state (the b2World::Dump equivalent,
    but exact: warm-start impulses, sweeps and sleep timers round-trip).
    np.savez of the leaves as leaf_0, leaf_1, ...; no pickle, so an
    untrusted checkpoint cannot run code on load."""
    arrays = {f"leaf_{i}": x.detach().cpu().numpy() for i, x in enumerate(_leaves(state))}
    if hasattr(path, "write"):
        np.savez(path, **arrays)
    else:
        # open the file here so that it lands at `path` exactly (np.savez
        # appends ".npz" to a bare path)
        with open(path, "wb") as f:
            np.savez(f, **arrays)


def load_state(path, like: State) -> State:
    """Restore a checkpoint written by `save_state` (or by the JAX
    package's). `like` gives the structure, the capacities and the device:
    any State with the same capacities, e.g. the freshly built scene. A
    leaf without the world axis (a single-world JAX checkpoint) gets
    `like`'s. np.load without pickle."""
    if like is None:
        raise ValueError("pass `like=` a State with matching capacities")
    ref = list(_leaves(like))
    with np.load(path, allow_pickle=False) as payload:
        arrays = [payload[f"leaf_{i}"] for i in range(len(payload.files))]
    if len(arrays) != len(ref):
        raise ValueError(f"the checkpoint has {len(arrays)} leaves, the State {len(ref)}")
    out = []
    for i, (a, r) in enumerate(zip(arrays, ref)):
        if a.ndim == r.dim() - 1:
            a = np.broadcast_to(a, (r.shape[0],) + a.shape)
        if tuple(a.shape) != tuple(r.shape) or a.dtype != r.cpu().numpy().dtype:
            raise ValueError(f"leaf {i}: {a.dtype} {a.shape} in the checkpoint, "
                             f"{r.dtype} {tuple(r.shape)} in `like`")
        out.append(torch.from_numpy(np.array(a)).to(r.device))
    return _rebuild(like, iter(out))


def dump(state: State) -> str:
    """b2World::Dump analog: a readable summary of each world (the exact
    state itself checkpoints through save_state)."""
    c = counts(state)
    lines = []
    for w in range(state.n_worlds):
        lines.append(f"box2d_mt_tpu_torch world {w}:")
        for k, v in c.items():
            lines.append(f"  {k}: {v[w]}")
        lines.append(f"  gravity: {state.gravity[w].cpu().numpy().tolist()}")
        lines.append(f"  capacities: bodies={state.bodies.capacity} "
                     f"fixtures={state.fixtures.capacity} "
                     f"contacts={state.contacts.capacity}")
    return "\n".join(lines)


def _g(x):
    """A float32 formatted so that it round-trips exactly (9 significant
    digits)."""
    return f"{float(x):.9g}"


def dump_source(state: State, world: int = 0) -> str:
    """b2World::Dump analog (b2World.h:246-248): Python source that
    rebuilds world `world` of the batch through the port's WorldBuilder:
    bodies with their current transforms and velocities, fixtures with
    their exact geometry and materials, joints as raw local-frame defs
    (WorldBuilder.create_joint_raw), and the original capacities. exec()
    the source (or import it from a file); it defines `state`, a one-world
    State on the device this state is on.

    Like the reference's Dump, runtime-only solver state is NOT emitted:
    the contact table, warm-start impulses, sleep timers and pending
    force/torque accumulators start fresh. Empty slots are compacted, so
    slots are renumbered in the replay, and joint body references with
    them."""
    from .joints import _BLOCK_NAMES

    def host(obj):
        return type(obj)(**{f.name: getattr(obj, f.name)[world].cpu().numpy()
                            for f in dataclasses.fields(obj)})

    b, fx = host(state.bodies), host(state.fixtures)
    xf_p = state.bodies.xf_p[world].cpu().numpy()
    out = []
    w = out.append
    w("# generated by box2d_mt_tpu_torch.diagnostics.dump_source (b2World::Dump analog)")
    w("import numpy as np")
    w("from box2d_mt_tpu_torch import shapes, settings")
    w("from box2d_mt_tpu_torch.world import WorldBuilder")
    w("from box2d_mt_tpu_torch.shapes import _polygon_centroid")
    w("")
    w(f"device = {str(state.gravity.device)!r}")
    gx, gy = state.gravity[world].cpu().numpy()
    w(f"wb = WorldBuilder(gravity=({_g(gx)}, {_g(gy)}))")

    # bodies, compacted in slot order
    body_map = {}
    for i in range(b.body_type.shape[0]):
        if b.body_type[i] < 0:
            continue
        body_map[i] = len(body_map)
        # the state keeps the center-of-mass velocity; create_body takes the
        # body-origin velocity and shifts it back (b2Body::ResetMassData)
        lvx = float(b.v[i, 0]) + float(b.w[i]) * (float(b.c[i, 1]) - float(xf_p[i, 1]))
        lvy = float(b.v[i, 1]) - float(b.w[i]) * (float(b.c[i, 0]) - float(xf_p[i, 0]))
        w(f"b{body_map[i]} = wb.create_body(body_type={int(b.body_type[i])},"
          f" position=({_g(xf_p[i, 0])}, {_g(xf_p[i, 1])}),"
          f" angle={_g(b.a[i])},"
          f" linear_velocity=({_g(lvx)}, {_g(lvy)}),"
          f" angular_velocity={_g(b.w[i])},"
          f" linear_damping={_g(b.linear_damping[i])},"
          f" angular_damping={_g(b.angular_damping[i])},"
          f" allow_sleep={bool(b.allow_sleep[i])},"
          f" awake={bool(b.awake[i])},"
          f" fixed_rotation={bool(b.fixed_rotation[i])},"
          f" bullet={bool(b.bullet[i])},"
          f" enabled={bool(b.enabled[i])},"
          f" gravity_scale={_g(b.gravity_scale[i])})")

    # fixtures, compacted in slot order (a chain became ghost-connected
    # edges at build time, and dumps as those)
    def arr(a):
        rows = ", ".join(f"[{_g(x)}, {_g(y)}]" for x, y in a)
        return f"np.array([{rows}], np.float32)"

    for i in range(fx.body.shape[0]):
        if fx.body[i] < 0:
            continue
        t = int(fx.shape_type[i])
        if t == settings.SHAPE_CIRCLE:
            sh = (f"shapes.Circle({_g(fx.radius[i])},"
                  f" ({_g(fx.verts[i, 0, 0])}, {_g(fx.verts[i, 0, 1])}))")
        elif t == settings.SHAPE_EDGE:
            v0 = (f"({_g(fx.verts[i, 2, 0])}, {_g(fx.verts[i, 2, 1])})"
                  if fx.ghosts[i, 0] else "None")
            v3 = (f"({_g(fx.verts[i, 3, 0])}, {_g(fx.verts[i, 3, 1])})"
                  if fx.ghosts[i, 1] else "None")
            sh = (f"shapes.Edge(({_g(fx.verts[i, 0, 0])}, {_g(fx.verts[i, 0, 1])}),"
                  f" ({_g(fx.verts[i, 1, 0])}, {_g(fx.verts[i, 1, 1])}),"
                  f" v0={v0}, v3={v3})")
        else:
            n = int(fx.nverts[i])
            vs = arr(fx.verts[i, :n])
            sh = (f"shapes.Polygon({vs}, {arr(fx.normals[i, :n])}, _polygon_centroid({vs}),"
                  f" radius={_g(fx.radius[i])})")
        w(f"wb.create_fixture(b{body_map[int(fx.body[i])]}, {sh},"
          f" density={_g(fx.density[i])},"
          f" friction={_g(fx.friction[i])},"
          f" restitution={_g(fx.restitution[i])},"
          f" is_sensor={bool(fx.is_sensor[i])},"
          f" filter_category={int(fx.filter_category[i])},"
          f" filter_mask={int(fx.filter_mask[i])},"
          f" filter_group={int(fx.filter_group[i])},"
          f" thick_shape={bool(fx.thick_shape[i])})")

    # joints: the active slots of each kind as raw def fields; impulses and
    # the active mask are runtime state and stay out
    blocks = {kind: host(getattr(state.joints, kind)) for kind in _BLOCK_NAMES}
    jcap = {kind: blk.body_a.shape[0] for kind, blk in blocks.items() if blk.body_a.shape[0]}
    jmaps = {kind: {i: n for n, i in enumerate(np.flatnonzero(blk.active))}
             for kind, blk in blocks.items()}
    for kind, blk in blocks.items():
        for i in sorted(jmaps[kind]):
            fields = []
            for f in dataclasses.fields(blk):
                name = f.name
                if name == "active" or "impulse" in name:
                    continue
                val = getattr(blk, name)[i]
                if name in ("body_a", "body_b", "body_c", "body_d"):
                    fields.append(f"{name}={body_map[int(val)]}")
                elif name in ("joint1_index", "joint2_index"):
                    # a gear names joints of the revolute/prismatic blocks:
                    # remap through those blocks' compaction
                    tval = int(getattr(blk, name.replace("index", "type"))[i])
                    ref_kind = "revolute" if tval == 0 else "prismatic"
                    fields.append(f"{name}={jmaps[ref_kind][int(val)]}")
                elif val.dtype == np.bool_:
                    fields.append(f"{name}={bool(val)}")
                elif np.issubdtype(val.dtype, np.integer):
                    fields.append(f"{name}={int(val)}")
                elif val.ndim == 1:
                    fields.append(f"{name}=({_g(val[0])}, {_g(val[1])})")
                else:
                    fields.append(f"{name}={_g(val)}")
            w(f"wb.create_joint_raw({kind!r}, {', '.join(fields)})")

    jc = "{" + ", ".join(f"{k!r}: {v}" for k, v in jcap.items()) + "}" if jcap else "None"
    w(f"state = wb.freeze(body_capacity={b.body_type.shape[0]},"
      f" fixture_capacity={fx.body.shape[0]},"
      f" contact_capacity={state.contacts.capacity},"
      f" joint_capacity={jc}, device=device)")
    w("")
    return "\n".join(out)


# the JAX package's 0x8da6b343 / 0xd8163841 spatial-hash primes as int32
_HASH_X, _HASH_Y = -1918851261, -669632447


def broadphase_quality(state: State, spread: bool = True) -> dict:
    """Broad-phase quality metrics of each world, the grid-hash analog of
    the tree-quality probes b2World::GetTreeHeight/GetTreeBalance/
    GetTreeQuality (b2World.h:198-206): the cell size, the large fixtures
    (which pair densely), the bucket loads of the small fixtures' covered
    cells and the pair table's fill. The buckets are those of the grid
    `ops.broadphase.find_pairs` runs: the hash's high bits with
    `GRID_CELL_SLOTS` slots a bucket (`spread`), or the JAX package's low
    bits (`spread=False`, 32 slots), which its own probe reports.
    `overfull_buckets` counts the buckets whose load passes the slots,
    where the grid drops entries. Values are (W,) numpy arrays."""
    from .ops.broadphase import GRID_CELL_SLOTS
    fx = state.fixtures
    nw, nf = fx.body.shape
    lo, hi, exists = fx.aabb_lo, fx.aabb_hi, fx.exists
    ext = torch.where(exists[..., None], hi - lo, 0.0)
    extent = torch.maximum(ext[..., 0], ext[..., 1])
    n_ex = exists.sum(1).clamp_min(1)
    sorted_ext = torch.sort(torch.where(exists, extent, float("inf")), dim=1).values
    median = torch.gather(sorted_ext, 1, (n_ex // 2).clamp(0, nf - 1)[:, None])
    cell = torch.clamp_min(1.5 * torch.where(torch.isfinite(median), median, 1.0),
                           10.0 * settings.LINEAR_SLOP)                  # (W, 1)
    is_large = exists & (extent > cell)
    n_buckets = max(16, 1 << (2 * nf - 1).bit_length())
    c0 = torch.floor(lo / cell[..., None]).to(torch.int32)
    c1 = torch.floor(hi / cell[..., None]).to(torch.int32)
    cx = torch.stack([c0[..., 0], c1[..., 0], c0[..., 0], c1[..., 0]], -1)
    cy = torch.stack([c0[..., 1], c0[..., 1], c1[..., 1], c1[..., 1]], -1)
    same_x, same_y = c1[..., 0] == c0[..., 0], c1[..., 1] == c0[..., 1]
    dup = torch.stack([torch.zeros_like(same_x), same_x, same_y, same_x | same_y], -1)
    h = (cx.long() * _HASH_X) ^ (cy.long() * _HASH_Y)
    bkt = ((h & 0xFFFFFFFF) >> (33 - n_buckets.bit_length()) if spread
           else h & (n_buckets - 1))
    small = (exists & ~is_large)[..., None] & ~dup
    loads = torch.zeros((nw, n_buckets + 1), dtype=torch.int32, device=lo.device)
    loads.scatter_add_(1, torch.where(small, bkt, n_buckets).reshape(nw, -1),
                       small.reshape(nw, -1).to(torch.int32))
    loads = loads[:, :n_buckets]
    slots = GRID_CELL_SLOTS if spread else 32
    host = lambda t: t.cpu().numpy()
    return {
        "cell_size": host(cell[:, 0]),
        "fixtures": host(n_ex),
        "large_fixtures": host(is_large.sum(1)),
        "max_bucket_load": host(loads.amax(1)),
        "mean_bucket_load": host(loads.sum(1).to(torch.float32)
                                 / (loads > 0).sum(1).clamp_min(1).to(torch.float32)),
        "pair_fill": host((state.contacts.f_a >= 0).to(torch.float32).mean(1)),
        "pair_capacity": int(state.contacts.capacity),
        "cell_slots": slots,
        "overfull_buckets": host((loads > slots).sum(1)),
    }
