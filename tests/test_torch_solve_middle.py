"""The port's solve middle against the JAX package's `_solve_middle_b`.

The JAX package rolls pyramid(6) x 2 worlds 30 steps (contacts begin near
step 13), its phases then prepare one more step's solve inputs, and the
same constraint rows, colors and warm-started velocities go through the
JAX middle and through the port's (the plain version on the CPU; the CUDA
kernel in the case that needs a card). With max_colors=3 the coloring
overflows: 14 lanes per world share the last color, fewer than either
package's Jacobi chunk width, so both solve them as one Jacobi chunk."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from box2d_mt_tpu import settings
from box2d_mt_tpu import world as W
from box2d_mt_tpu.models import scenes
from box2d_mt_tpu.ops import coloring as jcoloring
from box2d_mt_tpu.ops import islands as jislands
from box2d_mt_tpu.parallel.sharding import replicate_state
from box2d_mt_tpu_torch import world as tworld
from box2d_mt_tpu_torch.ops import solve_middle as tsm
from box2d_mt_tpu_torch.ops.solver import ContactConstraints

DT = 1.0 / 60.0
VI, PI = 8, 3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """These tensors are a few worlds wide: PyTorch's intra-op threads cost
    more than they give, and workers running side by side share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_pre_and_mids(states, kinds, mc):
    """The JAX step's phases up to and through the solve middle (fresh
    labels and colors, which equal the cached ones by construction)."""
    dt = jnp.float32(DT)
    nb = states.bodies.capacity
    man, sensor, sensor_touch, ba, bb = W._collide_b(states, kinds)
    enabled = jnp.ones(states.contacts.f_a.shape, bool)
    pt = jax.vmap(W._pre_touch)(states, man, sensor, sensor_touch, enabled,
                                ba, bb)
    labels = jax.vmap(lambda a, b, o, n: jislands.island_labels(nb, a, b, o, n))(
        ba, bb, pt.solvable, pt.non_static)
    awake, cc_active = jax.vmap(W._cc_active_of)(pt, labels, ba, bb)
    color, ov, rank = jax.vmap(lambda a, b, da, db, act: jcoloring.color_constraints(
        a, b, da, db, act, nb, mc, with_rank=True))(ba, bb, pt.dyn_a, pt.dyn_b,
                                                     cc_active)
    pre = jax.vmap(lambda s, p, l, aw, cca, co, rk, o, a_, b_: W._pre_finish(
        s, p, l, aw, cca, co, rk, o, dt, True, a_, b_))(
        states, pt, labels, awake, cc_active, color, rank, ov, ba, bb)
    mids, _ = W._solve_middle_b(states, pre, dt, VI, PI, True, mc)
    return pre, mids, pt.dyn_a, pt.dyn_b, ov


@pytest.fixture(scope="module")
def rolled():
    states = replicate_state(scenes.pyramid(6), 2)
    kinds = W.possible_kinds(scenes.pyramid(6))
    for _ in range(30):
        states, _ = W.step_batched(states, jnp.float32(DT), kinds=kinds,
                                   continuous=False, max_colors=16)
    return states, kinds


@pytest.fixture(scope="module", params=[16, 3], ids=["colors", "overflow"])
def captured(request, rolled):
    mc = request.param
    states, kinds = rolled
    out = jax.jit(_jax_pre_and_mids, static_argnums=(1, 2))(states, kinds, mc)
    pre, mids, dyn_a, dyn_b, ov = jax.tree.map(np.asarray, out)
    assert (int(ov.min()) > 0) if mc == 3 else (int(ov.max()) == 0)
    assert int(pre.cc.active.sum()) > 20         # real contacts are solved
    t = lambda x: torch.from_numpy(np.array(x))
    port_pre = types.SimpleNamespace(
        cc=ContactConstraints(**{k: t(getattr(pre.cc, k))
                                 for k in ContactConstraints._fields}),
        color=t(pre.color), ni_it=t(pre.ni_it), ti_it=t(pre.ti_it),
        bs=t(pre.bs), solve_mask=t(pre.solve_mask), dyn_a=t(dyn_a),
        dyn_b=t(dyn_b))
    bodies = jax.tree.map(np.asarray, states.bodies)
    return port_pre, t(bodies.c), t(bodies.a), mids, mc


def _run(port_pre, c, a, mc, middle, device="cpu"):
    to = lambda x: x.to(device)
    pre = types.SimpleNamespace(
        **{k: to(v) for k, v in vars(port_pre).items() if k != "cc"},
        cc=ContactConstraints(*(to(x) for x in port_pre.cc)))
    return tworld._solve_middle_b(to(c), to(a), pre, DT, VI, PI, mc, middle)


def test_plain_middle_matches_jax(captured):
    port_pre, c, a, mids, mc = captured
    got = _run(port_pre, c, a, mc, tsm.solve_middle)      # CPU: plain version
    ni, ti, jc, ja, jv, jw, jms = mids[:7]
    np.testing.assert_allclose(got.c.numpy(), jc, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.a.numpy(), ja, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.v.numpy(), jv, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.w.numpy(), jw, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.ni_it.numpy(), ni, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.ti_it.numpy(), ti, rtol=0, atol=1e-4)
    # only the convergence predicate of min_sep is consumed (sleep)
    slop = -3.0 * settings.LINEAR_SLOP
    np.testing.assert_array_equal(got.min_sep.numpy() >= slop, jms >= slop)


@pytest.mark.gpu
def test_kernel_matches_plain_on_card(captured, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the solve-middle kernel runs only on a card")
    port_pre, c, a, _, mc = captured
    plain = _run(port_pre, c, a, mc, tsm.solve_middle_plain, "cuda")
    calls = []
    call = tsm._call

    def counted(name, *args, **kwargs):
        calls.append(name)
        return call(name, *args, **kwargs)

    monkeypatch.setattr(tsm, "_call", counted)
    kern = _run(port_pre, c, a, mc, tsm.solve_middle, "cuda")
    torch.cuda.synchronize()
    assert calls == ["solve_middle_launch"]
    for name, atol in (("c", 1e-5), ("a", 1e-5), ("v", 1e-4), ("w", 1e-4),
                       ("ni_it", 1e-4), ("ti_it", 1e-4)):
        torch.testing.assert_close(getattr(kern, name), getattr(plain, name),
                                   rtol=0, atol=atol)
