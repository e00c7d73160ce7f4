"""Island labels, awake propagation and sleep, batched over worlds.

Port of `box2d_mt_tpu.ops.islands` (reference: b2World.cpp:1207-1330,
b2Island.cpp:355-395). Labels are the minimum body index of each island
of non-static bodies joined by active edges, found by min-label
propagation with pointer jumping. The JAX package computes the same
labels for N <= 256 by a boolean transitive closure on the matrix unit,
and above by propagation capped at its settings.ISLAND_ROUNDS (16); here
propagation runs to its fixed point for every N, so that an island is
whole as b2World::Solve's depth-first search makes it. The cap cuts the
labels of a 2800-box pile (multithread_demo) for some steps of its
settling, and sleep is decided island by island.
"""

import torch

from .. import settings
from ..math2d import take
from .sync import HostSyncs

BIGI = torch.iinfo(torch.int32).max


def island_labels(n_bodies: int, edges_a, edges_b, edge_active,
                  body_connectable, syncs: HostSyncs = None):
    """Connected-component labels over non-static bodies.

    edges_a/b (W, E) i32 endpoint slots, edge_active (W, E) bool,
    body_connectable (W, N) bool. Returns (W, N) i32 labels;
    unconnectable bodies keep their own index. Propagation runs until a
    round changes no label; each round reads one host predicate (counted
    in `syncs`) and is the event "islands.rounds"."""
    syncs = syncs or HostSyncs()
    nw = edges_a.shape[0]
    dev = edges_a.device
    ea = edges_a.clamp(0, n_bodies - 1).long()
    eb = edges_b.clamp(0, n_bodies - 1).long()
    link = edge_active & take(body_connectable, ea) & take(body_connectable, eb)
    ea = torch.where(link, ea, 0)
    eb = torch.where(link, eb, 0)
    dump = torch.full_like(ea, n_bodies)
    scat = torch.cat([torch.where(link, ea, dump), torch.where(link, eb, dump)], 1)
    labels = torch.arange(n_bodies, dtype=torch.int32, device=dev).expand(nw, -1)
    changed = True
    while changed:
        m = torch.minimum(take(labels, ea), take(labels, eb))
        mins = torch.full((nw, n_bodies + 1), BIGI, dtype=torch.int32, device=dev)
        mins.scatter_reduce_(1, scat, torch.cat([m, m], 1), "amin")
        new = torch.minimum(labels, mins[:, :n_bodies])
        # pointer jumping doubles propagation reach per round
        new = take(new, new.long())
        new = take(new, new.long())
        changed = syncs.flag((new != labels).any())
        syncs.event("islands.rounds")
        labels = new
    return labels.contiguous()


def propagate_awake(awake, labels, body_dynamic_or_kinematic):
    """Island-wide wake: if any member is awake, all are."""
    nw, n = awake.shape
    hit = torch.zeros(nw, n + 1, dtype=torch.bool, device=awake.device)
    src = torch.where(awake & body_dynamic_or_kinematic, labels.long(), n)
    hit.scatter_(1, src, True)
    island_awake = hit[:, :n]
    return torch.where(body_dynamic_or_kinematic,
                       take(island_awake, labels.long()), awake)


def update_sleep(bodies, labels, island_converged_by_label, dt: float,
                 allow_sleep_world: bool):
    """Per-body sleep timers + island-wide sleep decision
    (b2Island::Solve sleep block). Returns (awake, sleep_time)."""
    lin_tol2 = settings.LINEAR_SLEEP_TOLERANCE ** 2
    ang_tol2 = settings.ANGULAR_SLEEP_TOLERANCE ** 2
    vx, vy = bodies.v[..., 0], bodies.v[..., 1]
    moving = (bodies.w * bodies.w > ang_tol2) | (vx * vx + vy * vy > lin_tol2)
    non_static = bodies.exists & ~bodies.is_static
    cant_sleep = ~bodies.allow_sleep | moving
    sleep_time = torch.where(
        non_static & bodies.awake,
        torch.where(cant_sleep, 0.0, bodies.sleep_time + dt),
        bodies.sleep_time)
    if not allow_sleep_world:
        return bodies.awake, sleep_time
    nw, n = sleep_time.shape
    member = non_static & bodies.awake
    island_min = torch.full((nw, n + 1), float("inf"), device=sleep_time.device)
    island_min.scatter_reduce_(1, torch.where(member, labels.long(), n),
                               torch.where(member, sleep_time, float("inf")),
                               "amin")
    island_sleeps = ((island_min[:, :n] >= settings.TIME_TO_SLEEP)
                     & island_converged_by_label)
    goes_to_sleep = member & take(island_sleeps, labels.long())
    return torch.where(goes_to_sleep, False, bodies.awake), sleep_time
