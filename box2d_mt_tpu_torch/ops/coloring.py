"""Greedy graph coloring of the constraint graph, batched over worlds.

Port of `box2d_mt_tpu.ops.coloring`: no two constraints in a color share a
*dynamic* body, so a color is one conflict-free parallel pass of the
Gauss-Seidel solver. The colors and within-color ranks are EQUAL to the
JAX package's (they fix the Gauss-Seidel order), so both of its tiers are
ported as they are:

  * K <= 2048: Luby-style maximal independent sets by slot priority, with
    the (K, K) conflict matrix as a float32 batched product of 0/1 values
    (`_luby`, the plain version);
  * K > 2048: Jones-Plassmann with bit-reversed slot priorities and
    per-body color bitmasks (held in int64 lanes here; at most 32 colors).

With fixed slot priorities the Luby tier's sets are those of first-fit
greedy coloring in slot order, which K7 (csrc/coloring.cu,
`color_walk_kernel`) computes on a card: one block a world walks its slots
in order over per-body color bitmasks, in one launch and with no host
read. `color_constraints` takes K7 for every CUDA batch of the Luby tier
and `_luby` for the tier on other devices; `color_walk` is K7's wrapper,
and the card-only tests hold it to `_luby` bit for bit.

Loops whose trip count depends on the data read one host predicate per
iteration, counted in `syncs`. A world that finishes early idles through
the remaining iterations, which change nothing, as under the JAX
package's vmapped while loops.
"""

import torch

from .. import cuda_build
from ..cuda_build import need
from ..math2d import take
from .sync import HostSyncs

BIG = torch.iinfo(torch.int32).max
LUBY_MAX_SLOTS = 2048       # the Luby tier's K; Jones-Plassmann above
WALK_MAX_COLORS = 32        # K7's per-body masks are 32 bits


def color_constraints(body_a, body_b, conflict_a, conflict_b, active,
                      n_bodies: int, max_colors: int, with_rank: bool = False,
                      syncs: HostSyncs = None):
    """Color a batch of constraint sets.

    body_a/body_b (W, K) endpoint slots, conflict_a/b (W, K) bool (dynamic
    endpoints), active (W, K) bool. Returns (color (W, K) i32 with -1 for
    inactive, overflow (W,) i32) and with `with_rank` the rank of each
    constraint within its color in slot order. A launch of K7 is the
    event "coloring.kernel" in `syncs`, a round of Jones-Plassmann the
    event "coloring.jp_rounds"."""
    syncs = syncs or HostSyncs()
    k = body_a.shape[1]
    if k > LUBY_MAX_SLOTS:
        color, overflow, rank = _jones_plassmann(
            body_a, body_b, conflict_a, conflict_b, active, n_bodies,
            max_colors, syncs)
    elif body_a.device.type == "cuda":
        color, overflow, rank = color_walk(body_a, body_b, conflict_a, conflict_b,
                                           active, n_bodies, max_colors)
        syncs.event("coloring.kernel")
    else:
        color, overflow, rank = _luby(body_a, body_b, conflict_a, conflict_b,
                                      active, n_bodies, max_colors, syncs)
    if with_rank:
        return color, overflow, rank
    return color, overflow


def color_walk(body_a, body_b, conflict_a, conflict_b, active, n_bodies: int,
               max_colors: int):
    """K7: the Luby tier's (color, overflow, rank) of CUDA tensors in one
    launch on PyTorch's current stream, equal to `_luby`'s. body_a/body_b
    (W, K) int64, conflict_a/b and active (W, K) bool, all contiguous on
    one card, max_colors in [1, 32]; refuses anything else before any
    launch."""
    fn = "color_walk"
    if body_a.dim() != 2:
        raise ValueError(f"{fn}: body_a must be (W, K), got {tuple(body_a.shape)}")
    shape, dev = tuple(body_a.shape), body_a.device
    for name, t, dtype in (("body_a", body_a, torch.int64),
                           ("body_b", body_b, torch.int64),
                           ("conflict_a", conflict_a, torch.bool),
                           ("conflict_b", conflict_b, torch.bool),
                           ("active", active, torch.bool)):
        need(fn, name, t, dtype, shape, dev)
    if not 1 <= max_colors <= WALK_MAX_COLORS:
        raise ValueError(f"{fn}: max_colors={max_colors} outside the kernel's "
                         f"[1, {WALK_MAX_COLORS}]")
    if dev.type != "cuda":
        raise ValueError(f"{fn}: the kernel needs CUDA tensors, got {dev}")
    return _launch(body_a, body_b, conflict_a, conflict_b, active, n_bodies,
                   max_colors)


def _launch(body_a, body_b, conflict_a, conflict_b, active, n_bodies, max_colors):
    """One launch of csrc/coloring.cu; raises when the launch is refused."""
    nw, k = body_a.shape
    dev = body_a.device
    color = torch.empty((nw, k), dtype=torch.int32, device=dev)
    rank = torch.empty_like(color)
    overflow = torch.empty(nw, dtype=torch.int32, device=dev)
    masks = torch.empty((nw, n_bodies), dtype=torch.int32, device=dev)
    cuda_build.call(
        "coloring", "color_launch", dev,
        (body_a, body_b, conflict_a, conflict_b, active, color, rank, overflow, masks),
        (nw, k, n_bodies, max_colors))
    return color, overflow, rank


def _luby(body_a, body_b, conflict_a, conflict_b, active, n_bodies,
          max_colors, syncs):
    nw, k = body_a.shape
    dev = body_a.device
    rng = torch.arange(n_bodies, device=dev)
    xa = (conflict_a & active)[..., None] & (body_a[..., None] == rng)
    xb = (conflict_b & active)[..., None] & (body_b[..., None] == rng)
    x = (xa | xb).to(torch.float32)                          # (W, K, N)
    conflict = torch.bmm(x, x.transpose(1, 2)) > 0.0
    conflict &= ~torch.eye(k, dtype=torch.bool, device=dev)
    prio = torch.arange(k, device=dev)
    conf_lower = (conflict & (prio[:, None] > prio[None, :])).to(torch.float32)
    conflict_f = conflict.to(torch.float32)

    def hits(mat, vec):
        return torch.bmm(mat, vec.to(torch.float32)[..., None])[..., 0] > 0.0

    color = torch.full((nw, k), -1, dtype=torch.int32, device=dev)
    rank = torch.zeros((nw, k), dtype=torch.int32, device=dev)
    remaining = active.clone()
    c = 0
    while c < max_colors - 1 and syncs.flag(remaining.any()):
        # maximal independent set among `remaining` by priority minima
        chosen = torch.zeros_like(remaining)
        cand = remaining
        while syncs.flag(cand.any()):
            winner = cand & ~hits(conf_lower, cand)
            chosen = chosen | winner
            cand = cand & ~winner & ~hits(conflict_f, winner)
        color = torch.where(chosen, c, color)
        rank = torch.where(chosen, torch.cumsum(chosen, 1, dtype=torch.int32) - 1,
                           rank)
        remaining = remaining & ~chosen
        c += 1
    # overflow: park leftovers in the last color (Jacobi-sum fallback)
    overflow = remaining.sum(1).to(torch.int32)
    color = torch.where(remaining, max_colors - 1, color)
    rank = torch.where(remaining, torch.cumsum(remaining, 1, dtype=torch.int32) - 1,
                       rank)
    return color.to(torch.int32), overflow, rank.to(torch.int32)


def _bit_reversed_priority(k, device):
    """31-bit bit reversal of the slot index: unique positive priorities."""
    x = torch.arange(k, dtype=torch.int64, device=device)
    for sh, m in ((1, 0x55555555), (2, 0x33333333), (4, 0x0F0F0F0F),
                  (8, 0x00FF00FF)):
        x = ((x & m) << sh) & 0xFFFFFFFF | ((x >> sh) & m)
    x = ((x << 16) & 0xFFFFFFFF) | (x >> 16)
    return x >> 1


def _jones_plassmann(body_a, body_b, conflict_a, conflict_b, active,
                     n_bodies, max_colors, syncs):
    if max_colors > 32:
        raise ValueError("bitmask Jones-Plassmann supports <= 32 colors")
    nw, k = body_a.shape
    dev = body_a.device
    nb1 = n_bodies + 1
    idx_a = torch.where(conflict_a, body_a, n_bodies).clamp(0, nb1 - 1).long()
    idx_b = torch.where(conflict_b, body_b, n_bodies).clamp(0, nb1 - 1).long()
    hprio = _bit_reversed_priority(k, dev).expand(nw, -1)
    usable = (1 << (max_colors - 1)) - 1                  # bits 0..mc-2
    idx_ab = torch.cat([idx_a, idx_b], 1)
    conf_ab = torch.cat([conflict_a, conflict_b], 1)
    big = torch.iinfo(torch.int64).max

    color = torch.full((nw, k), -1, dtype=torch.int64, device=dev)
    remaining = active.clone()
    mask = torch.zeros((nw, nb1), dtype=torch.int64, device=dev)
    r = 0
    while r < k and syncs.flag(remaining.any()):
        syncs.event("coloring.jp_rounds")
        key = torch.where(remaining, hprio, big)
        mins = torch.full((nw, nb1), big, dtype=torch.int64, device=dev)
        mins.scatter_reduce_(1, idx_ab,
                             torch.where(conf_ab, torch.cat([key, key], 1), big),
                             "amin")
        winner = (remaining
                  & (~conflict_a | (take(mins, idx_a) == hprio))
                  & (~conflict_b | (take(mins, idx_b) == hprio)))
        # smallest usable color absent from both bodies' masks; all taken
        # -> park in the last color (the Jacobi fallback)
        free = ~(take(mask, idx_a) | take(mask, idx_b)) & usable
        lsb = free & -free
        c_new = torch.full_like(free, max_colors - 1)
        for bit in range(max_colors - 2, -1, -1):
            c_new = torch.where(lsb == (1 << bit), bit, c_new)
        color = torch.where(winner, c_new, color)
        bit = torch.where(winner, torch.ones_like(c_new) << c_new, 0)
        upd = torch.zeros((nw, nb1), dtype=torch.int64, device=dev)
        upd.scatter_reduce_(1, idx_ab,
                            torch.where(conf_ab, torch.cat([bit, bit], 1), 0),
                            "amax")
        mask = mask | upd
        remaining = remaining & ~winner
        r += 1
    overflow = (active & (color == max_colors - 1)).sum(1).to(torch.int32)
    oh = ((color[..., None] == torch.arange(max_colors, device=dev))
          & active[..., None])
    ranks = torch.cumsum(oh, 1, dtype=torch.int32) - 1          # (W, K, MC)
    rank = torch.gather(ranks, 2, color.clamp_min(0)[..., None])[..., 0]
    rank = torch.where(active, rank, 0)
    color = torch.where(active, color, -1)
    return color.to(torch.int32), overflow, rank.to(torch.int32)
