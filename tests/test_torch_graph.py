"""Island labels and constraint colors of the port are EQUAL to the JAX
package's on seeded random graphs, in both tiers of each pass: labels by
closure (N <= 256) and by propagation (N > 256: the JAX package's stops
at 16 rounds, the port's at its fixed point, which these graphs reach
within 16), colors by Luby
maximal sets (K <= 2048) and by bitmask Jones-Plassmann (K > 2048). The
Luby tier also equals a first-fit walk in slot order, the plain statement
of the card's coloring kernel K7."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from box2d_mt_tpu.ops import coloring as jcoloring
from box2d_mt_tpu.ops import islands as jislands
from box2d_mt_tpu_torch.ops import coloring, islands
from box2d_mt_tpu_torch.ops.sync import HostSyncs

CASES = [(256, 64), (4096, 1024)]      # (constraints K, bodies N)


def _graph(k, n, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, n, k).astype(np.int32)
    b = rng.integers(0, n, k).astype(np.int32)
    # bodies 0..3 static (the ground): many edges touch them
    a[rng.random(k) < 0.2] = rng.integers(0, 4)
    dynamic = np.ones(n, bool)
    dynamic[:4] = False
    active = rng.random(k) < 0.8
    return a, b, dynamic[a], dynamic[b], active, dynamic


@pytest.mark.parametrize("k,n", CASES)
def test_island_labels_equal_jax(k, n):
    a, b, _, _, active, connectable = _graph(k, n, seed=k)
    want = jax.jit(functools.partial(jislands.island_labels, n))(
        a, b, active, connectable)
    t = lambda x: torch.from_numpy(x)[None]
    got = islands.island_labels(n, t(a), t(b), t(active), t(connectable))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))


@pytest.mark.parametrize("k,n", CASES)
def test_colors_and_ranks_equal_jax(k, n):
    a, b, ca, cb, active, _ = _graph(k, n, seed=k + 1)
    fn = jax.jit(functools.partial(jcoloring.color_constraints, n_bodies=n,
                                   max_colors=24, with_rank=True))
    jc, jov, jr = fn(jnp.asarray(a), jnp.asarray(b), jnp.asarray(ca),
                     jnp.asarray(cb), jnp.asarray(active))
    t = lambda x: torch.from_numpy(x)[None]
    tc, tov, tr = coloring.color_constraints(t(a), t(b), t(ca), t(cb),
                                             t(active), n, 24, with_rank=True)
    np.testing.assert_array_equal(tc[0].numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tr[0].numpy(), np.asarray(jr))
    assert int(tov[0]) == int(jov)
    assert int(np.asarray(jc).max()) > 1        # a real multi-color graph


def _first_fit(a, b, ca, cb, active, n, max_colors):
    """The plain statement of K7 (csrc/coloring.cu): each world's slots in
    order take the smallest color in 0..MC-2 that no earlier slot sharing
    a conflicting endpoint holds, else MC-1 (which marks no body); a
    slot's rank is its place in its color, in slot order."""
    w, k = a.shape
    color = np.full((w, k), -1, np.int32)
    rank = np.zeros((w, k), np.int32)
    overflow = np.zeros(w, np.int32)
    last = max_colors - 1
    usable = (1 << last) - 1
    for wi in range(w):
        mask, count = [0] * n, [0] * max_colors
        for i in range(k):
            if not active[wi, i]:
                continue
            ends = [int(e) for e, c in ((a[wi, i], ca[wi, i]), (b[wi, i], cb[wi, i]))
                    if c and 0 <= e < n]
            taken = 0
            for e in ends:
                taken |= mask[e]
            avail = ~taken & usable
            c = (avail & -avail).bit_length() - 1 if avail else last
            color[wi, i], rank[wi, i] = c, count[c]
            count[c] += 1
            if c < last:
                for e in ends:
                    mask[e] |= 1 << c
        overflow[wi] = count[last]
    return color, overflow, rank


def _walk_graphs(seed, w=3):
    """W worlds of one random (K, N): ~20% static bodies, ~20% inactive
    slots, ~5% self-loops (body_a == body_b)."""
    rng = np.random.default_rng(seed)
    k, n = int(rng.integers(1, 301)), int(rng.integers(2, 65))
    a = rng.integers(0, n, (w, k))
    b = rng.integers(0, n, (w, k))
    loop = rng.random((w, k)) < 0.05
    b[loop] = a[loop]
    dynamic = rng.random((w, n)) >= 0.2
    ca = np.take_along_axis(dynamic, a, 1)
    cb = np.take_along_axis(dynamic, b, 1)
    active = rng.random((w, k)) >= 0.2
    return a, b, ca, cb, active, n


@pytest.mark.parametrize("max_colors", [1, 2, 3, 16, 32])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_luby_equals_first_fit_walk(seed, max_colors):
    """The Luby tier on the CPU (`_luby`, the plain version of K7) equals a
    first-fit walk in slot order: color, rank and overflow bit-equal."""
    a, b, ca, cb, active, n = _walk_graphs(seed)
    syncs = HostSyncs()
    t = torch.from_numpy
    color, overflow, rank = coloring.color_constraints(
        t(a), t(b), t(ca), t(cb), t(active), n, max_colors, with_rank=True,
        syncs=syncs)
    want_color, want_overflow, want_rank = _first_fit(a, b, ca, cb, active, n,
                                                      max_colors)
    np.testing.assert_array_equal(color.numpy(), want_color)
    np.testing.assert_array_equal(rank.numpy(), want_rank)
    np.testing.assert_array_equal(overflow.numpy(), want_overflow)
    assert "coloring.kernel" not in syncs.events        # K7 runs only on a card
    if max_colors <= 3:
        assert want_overflow.sum() > 0
