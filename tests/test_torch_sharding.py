"""The port's parallel/sharding.py: the world axis cut over devices, each
shard stepped from its own host thread.

  * Against the JAX package: its `make_sharded_step` on conftest's 8
    virtual CPU devices and the port's over 8 CPU shards, from the same
    built pyramid(5) x 16 worlds (tests/test_sharding.py's configuration,
    so JAX compiles that test's program), for 40 steps (the first contact
    comes after step 13): c, a to 2e-5, v, w to 1e-4, awake equal.
  * Against the unsharded port: 1, 2 and 4 shards of one padded batch of
    a pyramid(4) that falls asleep in the first steps, one already asleep,
    bullet_on_stack (a TOI impact with its mini island at step 14) and
    tumbler(30) (a revolute motor), so that a shard of sleeping worlds
    steps beside shards that move: every State leaf and every Events field
    but `host_syncs` equal bit for bit, every step.
  * The per-world overflow events: a world that needs no pair refresh or
    no TOI phase reports no overflow, whatever its batch-mates do; a
    mutation refreshes the pair table of its own world only.
  * The API (`batch_states` against JAX's, `make_batched_step` against
    `step_batched`), the refusals, and a shard's exception in the caller.
    (The step's counts under shard threads: tests/test_torch_trace.py.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from box2d_mt_tpu import world as jworld
from box2d_mt_tpu.models import scenes as jscenes
from box2d_mt_tpu.parallel import sharding as jsharding
from box2d_mt_tpu_torch import mutate
from box2d_mt_tpu_torch.models import scenes
from box2d_mt_tpu_torch.parallel import sharding
from box2d_mt_tpu_torch.state import concat_worlds, map_leaves, state_from_numpy
from box2d_mt_tpu_torch.world import Events, possible_kinds, step_batched

DT = 1.0 / 60.0
CPU = torch.device("cpu")
STEPS = 20


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """These tensors are a few worlds wide: PyTorch's intra-op threads cost
    more than they give, and workers running side by side share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(state):
    out = []
    map_leaves(lambda t: out.append(t) or t, state)
    return out


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _unequal(a, b):
    """Names of the differing State leaves or Events fields of two steps,
    bit for bit (so -0.0 and 0.0 differ)."""
    (sa, ea), (sb, eb) = a, b
    bad = [i for i, (x, y) in enumerate(zip(_leaves(sa), _leaves(sb)))
           if not torch.equal(_bits(x), _bits(y))]
    bad += [name for name in Events._fields[:-1]
            if not torch.equal(_bits(getattr(ea, name)), _bits(getattr(eb, name)))]
    return bad


def test_sharded_step_matches_jax_sharded():
    mesh = Mesh(np.array(jax.devices()[:8]), axis_names=("worlds",))
    state = jscenes.pyramid(5)
    kinds = jworld.possible_kinds(state)
    jstep, jshard = jsharding.make_sharded_step(mesh, kinds=kinds)
    batched = jsharding.replicate_state(state, 16)
    jst = jshard(batched)
    tstep, tshard = sharding.make_sharded_step([CPU] * 8)
    tst = tshard(state_from_numpy(jax.tree.map(np.asarray, batched), device="cpu"))
    assert tst.kinds == tuple(kinds)
    touched = 0
    for i in range(40):
        jst, _ = jstep(jst, jnp.float32(DT))
        with torch.inference_mode():
            tst, tev = tstep(tst, DT)
        got, ev = tst.gather(), tev.gather()
        jb = jst.bodies
        for name, atol in (("c", 2e-5), ("a", 2e-5), ("v", 1e-4), ("w", 1e-4)):
            np.testing.assert_allclose(getattr(got.bodies, name).numpy(),
                                       np.asarray(getattr(jb, name)), rtol=0, atol=atol,
                                       err_msg=f"step {i + 1} {name}")
        np.testing.assert_array_equal(got.bodies.awake.numpy(), np.asarray(jb.awake))
        assert ev.host_syncs == sum(e.host_syncs for e in tev.shards)
        touched = max(touched, int(got.contacts.touching.sum()))
    tstep.close()
    assert touched > 0, "the roll never made a contact"


@pytest.fixture(scope="module")
def padded():
    """The padded batch (pyramid(4) after 60 steps alone and after 80,
    bullet_on_stack, tumbler(30)), its kinds, and the unsharded roll:
    [(state, events)] a step."""
    caps = dict(body_capacity=64, fixture_capacity=64, contact_capacity=256,
                joint_capacity={"revolute": 1})
    pyramid = scenes.pyramid(4, device="cpu", **caps)
    kinds = possible_kinds(pyramid)
    worlds = []
    with torch.inference_mode():
        for solo in (60, 20):
            for _ in range(solo):
                pyramid, _ = step_batched(pyramid, DT, kinds=kinds)
            worlds.append(pyramid)
        batch = concat_worlds(worlds + [scenes.bullet_on_stack(device="cpu", **caps),
                                        scenes.tumbler(30, device="cpu", **caps)])
        kinds = possible_kinds(batch)
        rolled, st = [], batch
        for _ in range(STEPS):
            st, ev = step_batched(st, DT, kinds=kinds)
            rolled.append((st, ev))
    return batch, kinds, rolled


def test_padded_batch_has_a_sleeping_shard_and_an_impact(padded):
    """The batch exercises what the shard test is for: from step 2 the
    first two worlds sleep (a shard of them takes the all-asleep path)
    while the others move, and the bullet meets the stack by TOI."""
    _, _, rolled = padded
    dynamic = lambda st: st.bodies.awake & (st.bodies.body_type == 2)
    assert dynamic(rolled[0][0])[0].any()
    for st, _ in rolled[2:]:
        assert dynamic(st).any(1).tolist() == [False, False, True, True]
    assert sum(int(ev.toi_begin[2].sum()) for _, ev in rolled) > 0
    assert sum(int(ev.toi_begin[:2].sum()) for _, ev in rolled) == 0


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_shards_equal_unsharded_bit_for_bit(padded, n_shards):
    batch, kinds, rolled = padded
    step, shard = sharding.make_sharded_step([CPU] * n_shards, kinds=kinds)
    st = shard(batch)
    assert [s.n_worlds for s in st.shards] == [4 // n_shards] * n_shards
    for i, (want_st, want_ev) in enumerate(rolled):
        with torch.inference_mode():
            st, ev = step(st, DT)
        got = (st.gather(), ev.gather())
        assert got[1].host_syncs == sum(e.host_syncs for e in ev.shards)
        assert not _unequal(got, (want_st, want_ev)), f"step {i + 1}"
    step.close()


@pytest.mark.parametrize("case", ["pair", "toi"])
@torch.inference_mode()
def test_overflow_events_are_per_world(case):
    """World 0 rests (after its solo steps) beside a world that falls. Its
    pair table overflows a 16-slot table ("pair"), or its TOI candidates a
    capacity of 2 ("toi"), but it reports overflow only from its own pair
    refresh or TOI phase: the step of the pair equals the step of two
    shards of one world, bit for bit."""
    contact_capacity, solo, kw = {
        "pair": (16, 45, {}),
        "toi": (64, 60, dict(toi_capacity=2, allow_sleep=False))}[case]
    rest = scenes.pyramid(4, device="cpu", contact_capacity=contact_capacity)
    kinds = possible_kinds(rest)
    for _ in range(solo):
        rest, _ = step_batched(rest, DT, kinds=kinds, **kw)
    batch = concat_worlds([rest, scenes.pyramid(4, device="cpu",
                                                contact_capacity=contact_capacity)])
    step, shard = sharding.make_sharded_step([CPU, CPU], kinds=kinds, **kw)
    st, sh, field = batch, shard(batch), f"{case}_overflow"
    shown = False
    for i in range(10):
        st, ev = step_batched(st, DT, kinds=kinds, **kw)
        sh, sev = step(sh, DT)
        assert not _unequal((sh.gather(), sev.gather()), (st, ev)), f"step {i + 1}"
        rest_ovf, fall_ovf = getattr(ev, field).tolist()
        shown |= fall_ovf > 0 and rest_ovf == 0
    step.close()
    assert shown, f"no step reported {field} for the falling world alone"


@torch.inference_mode()
def test_mutation_of_one_world_keeps_shards_equal():
    """A between-step mutation marks its own world's pair table dirty (here
    a box of world 0 stops colliding with anything); the refresh at the
    start of the next step leaves the other worlds as they are, so the
    shards still equal the unsharded step."""
    batch = sharding.replicate_state(scenes.pyramid(3, device="cpu"), 2)
    kinds = possible_kinds(batch)
    step, shard = sharding.make_sharded_step([CPU, CPU], kinds=kinds)
    st, sh = batch, shard(batch)
    for i in range(12):
        if i == 4:
            box = torch.tensor([2, -1])             # world 0's fixture 2; world 1 alone
            st = mutate.set_filter(st, box, mask=0)
            sh = shard(mutate.set_filter(sh.gather(), box, mask=0))
            assert st.pairs_dirty.tolist() == [True, False]
        st, ev = step_batched(st, DT, kinds=kinds)
        sh, sev = step(sh, DT)
        assert not _unequal((sh.gather(), sev.gather()), (st, ev)), f"step {i + 1}"
    step.close()


def test_batch_states_matches_jax():
    one = jscenes.pyramid(4)
    two = jax.tree.map(lambda x: x + 1 if x.dtype == jnp.float32 else x, one)
    want = jsharding.batch_states([one, two])
    got = sharding.batch_states([state_from_numpy(jax.tree.map(np.asarray, s), device="cpu")
                                 for s in (one, two)])
    ref = state_from_numpy(jax.tree.map(np.asarray, want), device="cpu")
    for x, y in zip(_leaves(got), _leaves(ref)):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="one-world States"):
        sharding.batch_states([got])
    assert sharding.replicate_state(got, 3).n_worlds == 6


def test_make_batched_step_matches_step_batched():
    batch = sharding.replicate_state(scenes.pyramid(3, device="cpu"), 2)
    kinds = possible_kinds(batch)
    step = sharding.make_batched_step(velocity_iterations=6)
    a = b = batch
    for _ in range(3):
        a, ea = step(a, DT)
        b, eb = step_batched(b, DT, kinds=kinds, velocity_iterations=6)
        assert not _unequal((a, ea), (b, eb))
    rolled = sharding.make_rollout(3, velocity_iterations=6)(batch, DT)
    assert not _unequal((rolled, ea), (a, ea))


def test_refusals():
    batch = sharding.replicate_state(scenes.pyramid(2, device="cpu"), 3)
    step, shard = sharding.make_sharded_step([CPU, CPU])
    with pytest.raises(ValueError, match="3 worlds do not split evenly over 2 devices"):
        shard(batch)
    step.close()


def test_no_card_and_no_devices_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sharding.make_sharded_step()


def test_shard_exception_reaches_the_caller():
    batch = sharding.replicate_state(scenes.pyramid(2, device="cpu"), 2)
    step, shard = sharding.make_sharded_step([CPU, CPU], max_colors=64)
    st = shard(batch)
    with pytest.raises(ValueError, match="max_colors must be in"):
        step(st, DT)
    step.close()


