"""The port's PBD rope (Rope/b2Rope.cpp) against the reference and the JAX
package.

  * rope_pbd_240: the C++ trace of a 40-vertex rope, pinned at two
    vertices and bent by SetAngle(pi/4), within 2e-3 over the first 60
    steps and 0.05 over all 240 (the JAX bounds, tests/test_rope.py:33-34),
    stepped as one batch of four ropes;
  * the batched form: four ropes with different stiffness, damping and
    gravity step together, each equal to its own one-rope roll, and the
    first equal to the JAX package's rope_step within 1e-5 over 10 steps;
  * a step of h = 0 changes nothing.
"""

import jax
import numpy as np
import pytest
import torch

from box2d_mt_tpu import rope as jrope
from box2d_mt_tpu_torch import rope

from conftest import load_jsonl

N = 40


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _args():
    vertices = [(0.0, 20.0 - 0.25 * i) for i in range(N)]
    masses = [0.0, 0.0] + [1.0] * (N - 2)
    return vertices, masses


def _build(gravity=(0.0, -10.0), damping=0.1, k2=1.0, k3=0.5):
    st = rope.make_rope(*_args(), gravity=gravity, damping=damping, k2=k2, k3=k3,
                        device="cpu")
    return rope.set_angle(st, 0.25 * 3.14159265)


def test_rope_matches_reference():
    st = rope.replicate(_build(), 4)
    ref = load_jsonl("rope_pbd_240.jsonl")
    errs = []
    for i in range(240):
        st = rope.rope_step(st, 1 / 60, 1)
        errs.append(np.abs(st.ps.numpy() - np.asarray(ref[i]["ps"])[None]).max())
    print(f"worst error: steps 0-59 {max(errs[:60]):.3g}, 0-239 {max(errs):.3g}")
    assert max(errs[:60]) < 2e-3
    assert max(errs) < 0.05


def _mixed():
    params = [dict(), dict(k2=0.8, k3=0.2), dict(damping=0.5), dict(gravity=(3.0, -9.0))]
    ropes = [_build(**p) for p in params]
    return ropes, rope.RopeState(*(torch.cat(x) for x in zip(*ropes)))


def test_rope_batched_and_against_jax():
    ropes, batch = _mixed()
    singles = list(ropes)
    jst = jrope.set_angle(jrope.make_rope(*_args(), gravity=(0.0, -10.0), damping=0.1,
                                          k2=1.0, k3=0.5), 0.25 * 3.14159265)
    jstep = jax.jit(lambda s: jrope.rope_step(s, 1 / 60, 1))
    for _ in range(10):
        batch = rope.rope_step(batch, 1 / 60, 1)
        singles = [rope.rope_step(s, 1 / 60, 1) for s in singles]
        jst = jstep(jst)
    for r, single in enumerate(singles):
        for a, b in zip(batch, single):
            assert torch.equal(a[r], b[0])
    assert not torch.equal(batch.ps[0], batch.ps[1])
    np.testing.assert_allclose(batch.ps[0].numpy(), np.asarray(jst.ps), atol=1e-5, rtol=0)
    np.testing.assert_allclose(batch.vs[0].numpy(), np.asarray(jst.vs), atol=1e-3, rtol=0)


def test_rope_zero_dt_noop():
    st = _build()
    st2 = rope.rope_step(st, 0.0, 1)
    assert torch.equal(st2.ps, st.ps) and torch.equal(st2.vs, st.vs)
