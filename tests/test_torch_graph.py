"""Island labels and constraint colors of the port are EQUAL to the JAX
package's on seeded random graphs, in both tiers of each pass: labels by
closure (N <= 256) and by capped propagation (N > 256), colors by Luby
maximal sets (K <= 2048) and by bitmask Jones-Plassmann (K > 2048)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from box2d_mt_tpu.ops import coloring as jcoloring
from box2d_mt_tpu.ops import islands as jislands
from box2d_mt_tpu_torch.ops import coloring, islands

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
