"""The port's continuous collision against the JAX package's.

* The plain time of impact (the counterpart of the TPU kernel) on the 200
  golden lanes of tests/golden/toi.jsonl (147 separated, 38 touching, 15
  overlapped) against `distance.time_of_impact` under vmap, the Pallas
  kernel in interpret mode and the C++ reference, with the repo's rule:
  states equal on all but max(2, n // 50) lanes, |dt| <= 5e-3 where
  touching (tests/test_pallas_toi.py:82-88).
* GJK distance against the goldens (tests/test_distance.py:43-45).
* The whole step with continuous=True: pyramid(6) x 2 worlds for 20
  steps (every bottom box reaches the ground in a TOI sub-step at step
  index 12); c, a to 2e-5, v, w to 1e-4, every discrete quantity equal.
* A fast box against a thin static wall, beside a bullet that lands next
  to a resting box (the mini island keeps and commits a dynamic
  neighbor). Each port step starts from the JAX state of the step before:
  the 200 m/s impact amplifies last-bit differences of sin/cos (one ulp of
  the box speed moves JAX's own w by 5e-5), so a free-running comparison
  would measure that noise, not the port. Free-running, the port's box
  stops at the wall with CCD and tunnels without it. The same comparison
  runs once more with toi_neighbors=False.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from box2d_mt_tpu import settings as jsettings
from box2d_mt_tpu import shapes as jshapes
from box2d_mt_tpu import world as jworld
from box2d_mt_tpu.models import scenes as jscenes
from box2d_mt_tpu.ops import distance as jdst
from box2d_mt_tpu.ops import narrowphase as jnph
from box2d_mt_tpu.ops import pallas_toi as ptoi
from box2d_mt_tpu.parallel.sharding import replicate_state
from box2d_mt_tpu_torch import math2d as tmath
from box2d_mt_tpu_torch import world as tworld
from box2d_mt_tpu_torch.ops import distance as tdst
from box2d_mt_tpu_torch.ops import toi as ttoi
from box2d_mt_tpu_torch.state import state_from_numpy, to_numpy

from conftest import GOLDEN
from test_pallas_toi import _build_lanes
from test_torch_kernels import fast_box_builder

DT = 1.0 / 60.0


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """These tensors are a few worlds wide: PyTorch's intra-op threads cost
    more than they give, and workers running side by side share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# lanes
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def golden():
    rows = [json.loads(line) for line in open(GOLDEN / "toi.jsonl")]

    def proxies(key):
        verts = np.zeros((len(rows), 8, 2), np.float32)
        for i, r in enumerate(rows):
            vs = np.asarray(r[key]["verts"], np.float32)
            verts[i, :len(vs)] = vs
        count = np.asarray([len(r[key]["verts"]) for r in rows], np.int32)
        radius = np.asarray([r[key]["radius"] for r in rows], np.float32)
        return verts, count, radius

    return dict(rows=rows, a=proxies("a"), b=proxies("b"),
                sa=np.asarray([r["sweepA"] for r in rows], np.float32),
                sb=np.asarray([r["sweepB"] for r in rows], np.float32))


def _lanes(g, active=None):
    """The golden lanes in time_of_impact_lanes' argument contract."""
    n = len(g["rows"])

    def side(proxy, sweep):
        verts, count, radius = proxy
        rows = np.concatenate([np.zeros((n, 2), np.float32), sweep], 1).T
        return (torch.from_numpy(np.ascontiguousarray(verts.transpose(2, 1, 0))),
                torch.from_numpy(count), torch.from_numpy(radius),
                torch.from_numpy(np.ascontiguousarray(rows)))

    act = torch.ones(n, dtype=torch.bool) if active is None else active
    return (*side(g["a"], g["sa"]), *side(g["b"], g["sb"]), torch.ones(n), act)


@pytest.fixture(scope="module")
def port_toi(golden):
    state, t = ttoi.time_of_impact_lanes(*_lanes(golden))
    return state.numpy(), t.numpy()


def _reference(golden, which):
    rows = golden["rows"]
    if which == "cpp":
        return (np.asarray([r["toi_state"] for r in rows]),
                np.asarray([r["toi_t"] for r in rows], np.float32))
    if which == "pallas":
        n = len(rows)
        state, t = ptoi.time_of_impact_lanes(*_build_lanes(rows)[:5], interpret=True)
        return np.asarray(state)[:n], np.asarray(t)[:n]
    (va, ca, ra), (vb, cb, rb) = golden["a"], golden["b"]
    zc = jnp.zeros(2, jnp.float32)
    fn = jax.jit(jax.vmap(
        lambda va, ca, ra, vb, cb, rb, s_a, s_b: jdst.time_of_impact(
            va, ca, ra, zc, s_a[0:2], s_a[2:4], s_a[4], s_a[5],
            vb, cb, rb, zc, s_b[0:2], s_b[2:4], s_b[4], s_b[5], jnp.float32(1.0))))
    state, t = fn(va, ca, ra, vb, cb, rb, golden["sa"], golden["sb"])
    return np.asarray(state), np.asarray(t)


@pytest.mark.parametrize("which", ["xla", "pallas", "cpp"])
def test_plain_toi_matches_reference_lanes(golden, port_toi, which):
    state, t = port_toi
    ref_state, ref_t = _reference(golden, which)
    n = len(state)
    bad = state != ref_state
    touch = ref_state == jdst.TOI_TOUCHING
    t_bad = touch & (np.abs(t - ref_t) > 5e-3)
    print(f"{which}: {bad.sum()}/{n} state mismatches, {t_bad.sum()}/{touch.sum()} "
          f"t mismatches, max |dt| touching {np.abs(t - ref_t)[touch].max():.3g}")
    assert touch.sum() >= 30 and (state == jdst.TOI_OVERLAPPED).sum() >= 10
    assert bad.sum() <= max(2, n // 50)
    assert t_bad.sum() <= max(2, int(touch.sum()) // 50)


def test_gjk_distance_matches_reference(golden):
    (va, ca, ra), (vb, cb, rb) = golden["a"], golden["b"]
    sa, sb = torch.from_numpy(golden["sa"]), torch.from_numpy(golden["sb"])
    T = torch.from_numpy
    d = tdst.gjk_distance(T(va), T(ca), T(ra), sa[:, 0:2], tmath.rot_from_angle(sa[:, 4]),
                          T(vb), T(cb), T(rb), sb[:, 0:2],
                          tmath.rot_from_angle(sb[:, 4]))[2].numpy()
    ref = np.asarray([r["dist"] for r in golden["rows"]])
    bad = np.abs(d - ref) > 1e-4 + 1e-3 * np.abs(ref)
    assert bad.sum() <= max(1, len(ref) // 100), f"{bad.sum()} distance mismatches"


def test_inactive_lanes_return_unknown(golden):
    n = len(golden["rows"])
    active = torch.zeros(n, dtype=torch.bool)
    active[::2] = True
    state, t = ttoi.time_of_impact_lanes(*_lanes(golden, active))
    assert torch.all(state[1::2] == tdst.TOI_UNKNOWN)
    assert torch.all(t[1::2] == 1.0)
    assert torch.any(state[::2] != tdst.TOI_UNKNOWN)


def test_wrapper_refuses_malformed_arguments(golden):
    args = list(_lanes(golden))
    bad = list(args)
    bad[1] = bad[1].long()
    with pytest.raises(ValueError, match="count_a"):
        ttoi.time_of_impact_lanes(*bad)
    bad = list(args)
    bad[3] = args[3].T.contiguous().T
    with pytest.raises(ValueError, match="contiguous"):
        ttoi.time_of_impact_lanes(*bad)
    bad = list(args)
    bad[8] = torch.ones(3)
    with pytest.raises(ValueError, match="t_max"):
        ttoi.time_of_impact_lanes(*bad)


# --------------------------------------------------------------------------
# the whole step
# --------------------------------------------------------------------------


def _equal_discrete(t, tev, j, jev, where):
    w = (slice(None),) if j.bodies.awake.ndim == 2 else (0,)
    for name, got, want in (
            ("awake", t.bodies.awake[w], j.bodies.awake),
            ("toi_count", t.contacts.toi_count[w], j.contacts.toi_count),
            ("touching", t.contacts.touching[w], j.contacts.touching),
            ("toi_begin", tev.toi_begin.numpy()[w], jev.toi_begin),
            ("toi_f_a", tev.toi_f_a.numpy()[w], jev.toi_f_a),
            ("toi_f_b", tev.toi_f_b.numpy()[w], jev.toi_f_b),
            ("toi_overflow", tev.toi_overflow.numpy()[w], jev.toi_overflow)):
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=f"{name} @{where}")


def _close(t, j, where):
    w = (slice(None),) if j.bodies.awake.ndim == 2 else (0,)
    for k, tol in (("c", 2e-5), ("a", 2e-5), ("v", 1e-4), ("w", 1e-4)):
        np.testing.assert_allclose(getattr(t.bodies, k)[w], getattr(j.bodies, k),
                                   rtol=0, atol=tol, err_msg=f"{k} @{where}")


@pytest.fixture(scope="module")
def pyramid_roll():
    jst = replicate_state(jscenes.pyramid(6), 2)
    kinds = jworld.possible_kinds(jscenes.pyramid(6))
    tst = state_from_numpy(jax.tree.map(np.asarray, jst), device="cpu")
    steps = []
    for _ in range(20):
        jst, jev = jworld.step_batched(jst, jnp.float32(DT), kinds=kinds)
        tst, tev = tworld.step_batched(tst, DT, kinds=kinds)
        steps.append((jax.tree.map(np.asarray, jst), jax.tree.map(np.asarray, jev),
                      to_numpy(tst), tev))
    return kinds, steps


def test_continuous_step_matches_jax(pyramid_roll):
    _, steps = pyramid_roll
    for i, (j, jev, t, tev) in enumerate(steps):
        _close(t, j, i)
        _equal_discrete(t, tev, j, jev, i)
    # every bottom box reaches the ground in a TOI sub-step at step index 12
    counts = [int(t.contacts.toi_count.sum()) for _, _, t, _ in steps]
    assert counts[12] == 12 and sum(counts) == 12, counts
    assert int(steps[12][3].toi_begin.sum()) == 12


def test_toi_neighbors_off_matches_on_for_pyramid(pyramid_roll):
    """The pyramid keeps no mini-island neighbor (the boxes' other
    contacts are box-box, which the admission rule refuses), so the step
    without mini islands follows the same trajectory."""
    kinds, steps = pyramid_roll
    tst = state_from_numpy(jax.tree.map(np.asarray, replicate_state(jscenes.pyramid(6), 2)),
                           device="cpu")
    for i in range(16):
        tst, ev = tworld.step_batched(tst, DT, kinds=kinds, toi_neighbors=False)
        t = to_numpy(tst)
        for k in ("c", "a", "v", "w"):
            np.testing.assert_array_equal(getattr(t.bodies, k), getattr(steps[i][2].bodies, k),
                                          err_msg=f"{k} @{i}")
        np.testing.assert_array_equal(t.contacts.toi_count, steps[i][2].contacts.toi_count)


_FAST_BOX_KINDS = (jnph.KIND_POLYGONS, jnph.KIND_EDGE_POLYGON)


def _fast_box_steps_match_jax(monkeypatch, toi_neighbors):
    """12 steps of the fast-box world, each port step from the JAX state of
    the step before, held against JAX's step with the same
    `toi_neighbors`. Returns the dynamic neighbors each mini island kept
    and the last JAX state."""
    kw = dict(max_colors=4, kinds=_FAST_BOX_KINDS, toi_neighbors=toi_neighbors)
    jst = fast_box_builder(jworld.WorldBuilder, jshapes, jsettings).freeze()
    committed = []
    island = tworld._MiniIsland.__init__

    def record(self, *a, **k):
        island(self, *a, **k)
        committed.append(int((self.n_keep & self.o_dyn).sum()))

    monkeypatch.setattr(tworld._MiniIsland, "__init__", record)
    for i in range(12):
        tst = state_from_numpy(jax.tree.map(np.asarray, jst), device="cpu")
        jst, jev = jworld.step(jst, DT, **kw)
        tst, tev = tworld.step(tst, DT, **kw)
        j, t = jax.tree.map(np.asarray, jst), to_numpy(tst)
        _close(t, j, i)
        _equal_discrete(t, tev, j, jax.tree.map(np.asarray, jev), i)
    return committed, j


def test_fast_box_stops_at_thin_wall(monkeypatch):
    kw = dict(max_colors=4)
    kinds = _FAST_BOX_KINDS
    jst = fast_box_builder(jworld.WorldBuilder, jshapes, jsettings).freeze()
    start = state_from_numpy(jax.tree.map(np.asarray, jst), device="cpu")
    committed, j = _fast_box_steps_match_jax(monkeypatch, toi_neighbors=True)
    assert sum(committed) >= 1          # a dynamic neighbor was committed
    assert float(j.bodies.c[2, 0]) < 10.0

    def roll(continuous):
        st = start
        for _ in range(12):
            st, _ = tworld.step(st, DT, kinds=kinds, continuous=continuous, **kw)
        return float(st.bodies.c[0, 2, 0]), int(st.contacts.toi_count.sum())

    x_ccd, _ = roll(True)
    x_plain, _ = roll(False)
    assert x_ccd < 10.0, f"tunneled with CCD: x={x_ccd}"
    assert x_plain > 10.5, f"stopped without CCD: x={x_plain}"


def test_fast_box_neighbors_off_matches_jax(monkeypatch):
    """The same scene without mini islands: the bullet's resting neighbor
    is no longer solved with it, and the step still equals JAX's."""
    committed, j = _fast_box_steps_match_jax(monkeypatch, toi_neighbors=False)
    assert committed == []              # no mini island was built
    assert float(j.bodies.c[2, 0]) < 10.0
