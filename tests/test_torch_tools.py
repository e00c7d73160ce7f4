"""The port's tools on the CPU: the consistency harness
(tools/consistency_torch.py) and the headless testbed
(tools/testbed_torch.py).

* The determinism checks of tests/test_determinism.py through
  `consistency_torch.run_scene`: pyramid(5), tumbler(30), gear_train and
  wheel_car, 4 lanes x 120 steps, and the bullet scene for 60 steps, each
  rolled twice (every State leaf equal) with every lane equal to lane 0;
  the mutation sequence (a body spawned at step 10, an impulse at step
  20) replayed twice. The same checks in one padded batch of two scenes
  (`run_batch`, as chip_smoke.py runs the list on the card).
* `run_batch` rolls on past the compared state for chip_smoke.py's golden
  batches, and each step of its first roll is seen by `on_step`.
* `math2d.add_at`, the summation behind the warm start and every joint
  pass, adds each row's values in the order they stand, run after run,
  at a size where the CPU's `index_put_` with accumulate does not.
* The testbed writes per-step SVG frames and one animated SVG for two
  scenes; each frame parses as XML and draws every fixture of every body
  where the port's draw_data puts it.
"""

import ast
import importlib
import pathlib
import sys
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
ct = importlib.import_module("consistency_torch")
testbed = importlib.import_module("testbed_torch")

from box2d_mt_tpu_torch import draw, settings, world  # noqa: E402
from box2d_mt_tpu_torch.math2d import add_at, add_rows  # noqa: E402
from box2d_mt_tpu_torch.models import scenes  # noqa: E402

SVG = "{http://www.w3.org/2000/svg}"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """These tensors are a few worlds wide: PyTorch's intra-op threads cost
    more than they give, and workers running side by side share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arg(fn, *a):
    return lambda device="cuda", **cap: fn(*a, device=device, **cap)


DETERMINISM = [
    ("pyramid5", _arg(scenes.pyramid, 5), 120),
    ("tumbler30", _arg(scenes.tumbler, 30), 120),
    ("gear_train", scenes.gear_train, 120),
    ("wheel_car", scenes.wheel_car, 120),
    ("bullet_wall", ct.bullet_wall, 60),
]


@pytest.mark.parametrize("name,build,steps", DETERMINISM, ids=[d[0] for d in DETERMINISM])
def test_scene_determinism(name, build, steps):
    row = ct.run_scene(build, steps, lanes=4, device="cpu", name=name)
    assert row["rerun_bitexact"] and row["lanes_bitexact"] and row["no_nan"], row
    assert row["passed"] and row["lanes"] == 4 and row["steps"] == steps


def test_mutation_sequence_determinism():
    row = ct.run_mutation_sequence(steps=40, lanes=2, device="cpu")
    assert row["passed"], row
    assert row["bodies"] == 12           # pyramid(4)'s ground and ten boxes, and the spawned one


def test_padded_batch_checks_each_scene():
    """Two scenes of different capacities in one batch: each keeps its own
    rows, lanes and body count; the batch is frozen at the larger
    capacities."""
    entries = [("hello_world", scenes.hello_world, 3),
               ("chain_links", _arg(scenes.chain_links, 3), 2)]
    state, spans = ct.padded_batch(entries, "cpu")
    assert state.n_worlds == 5 and [s[:2] for s in spans] == [(0, 3), (3, 2)]
    assert state.contacts.capacity == ct.capacities(scenes.chain_links(3, device="cpu"))[
        "contact_capacity"]
    rows = ct.run_batch(entries, 30, device="cpu")
    assert [r["scene"] for r in rows] == ["hello_world", "chain_links"]
    assert [r["bodies"] for r in rows] == [2, 4]
    assert all(r["passed"] and r["batch"] == "hello_world+chain_links" for r in rows)


def test_run_batch_rolls_on_past_the_compared_state():
    """`longer` steps more on the first roll, each seen by `on_step`, as
    chip_smoke.py rolls its golden batches: the rows compare the states
    after `steps` steps, and the first roll ends `longer` steps later."""
    seen = []
    rows = ct.run_batch([("pyramid3", _arg(scenes.pyramid, 3), 2)], 6, device="cpu",
                        on_step=lambda st, ev: seen.append(st.bodies.c.clone()), longer=4)
    assert len(seen) == 10 and rows[0]["passed"] and rows[0]["steps"] == 6
    st = scenes.pyramid(3, device="cpu")
    kinds = world.possible_kinds(st)
    for _ in range(10):
        st, _ = world.step_batched(st, 1 / 60, kinds=kinds)
    assert torch.equal(seen[-1][1], st.bodies.c[0])


def test_add_at_sums_each_row_in_order():
    """Two worlds of 4096 bodies, 16384 lanes each, three planes: 196,608
    values, above the 32,768 where the CPU's index_put_ with accumulate
    adds floats from several threads at once. add_at and add_rows equal
    numpy's unbuffered add.at, which adds in index order, in every run."""
    rng = np.random.default_rng(7)
    nw, n, m = 2, 4096, 16384
    idx = rng.integers(0, n, (nw, m))
    rows = ((np.arange(nw * 3).reshape(nw, 3, 1) * n + idx[:, None, :]).reshape(-1))
    base = rng.standard_normal(nw * 3 * n).astype(np.float32)
    values = rng.standard_normal(rows.size).astype(np.float32)
    want = base.copy()
    np.add.at(want, rows, values)
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        for _ in range(3):
            got = add_at(torch.from_numpy(base.copy()), torch.from_numpy(rows),
                         torch.from_numpy(values))
            assert got.numpy().tobytes() == want.tobytes()
        target = torch.from_numpy(base.reshape(nw, n, 3))
        delta = torch.from_numpy(values.reshape(nw, m, 3))
        acc = np.zeros(base.size, np.float32)
        flat = ((idx + n * np.arange(nw)[:, None])[..., None] * 3 + np.arange(3)).reshape(-1)
        np.add.at(acc, flat, values)
        got = add_rows(target, torch.from_numpy(idx), delta)
        assert got.numpy().tobytes() == (base + acc).reshape(nw, n, 3).tobytes()
    finally:
        torch.set_num_threads(threads)


def _shapes(svg_path):
    """(tag, coordinates) of every shape element of one SVG file."""
    root = ET.parse(svg_path).getroot()
    out = []
    for el in root.iter():
        tag = el.tag.replace(SVG, "")
        if tag == "circle":
            out.append((tag, (float(el.get("cx")), float(el.get("cy")))))
        elif tag == "line":
            out.append((tag, tuple(float(el.get(k)) for k in ("x1", "y1", "x2", "y2"))))
        elif tag == "polygon":
            out.append((tag, tuple(float(v) for p in el.get("points").split()
                                   for v in p.split(","))))
    return out


@pytest.mark.parametrize("scene,args", [("edge_shapes", "(8,)"), ("gear_train", "()")])
def test_testbed_frames_draw_every_body(tmp_path, scene, args):
    frames, anim = tmp_path / "frames", tmp_path / "anim.svg"
    assert testbed.main([scene, "--args", args, "--steps", "9", "--every", "4",
                         "--device", "cpu", "--frames", str(frames),
                         "--animate", str(anim)]) == 0
    assert sorted(p.name for p in frames.iterdir()) == [
        "frame_00000.svg", "frame_00004.svg", "frame_00008.svg"]
    assert len(ET.parse(anim).getroot().findall(f"{SVG}g")) == 3
    # the same roll here; the last frame draws each fixture where the
    # port's draw_data has it, in the testbed's view (640 x 480, 10 px/m,
    # centered on (0, 10))
    st = getattr(scenes, scene)(*ast.literal_eval(args), device="cpu")
    kinds = world.possible_kinds(st)
    for _ in range(9):
        st, _ = world.step(st, 1 / 60, kinds=kinds)
    got = _shapes(frames / "frame_00008.svg")
    d = draw.draw_data(st)
    exists = d.exists[0].numpy()
    bodies = {int(b) for b in d.body[0].numpy()[exists]}
    assert bodies == set(np.flatnonzero(st.bodies.body_type[0].numpy() >= 0).tolist())
    assert len(got) == int(exists.sum())
    px = np.stack([320 + d.verts[0, ..., 0].numpy() * 10,
                   240 - (d.verts[0, ..., 1].numpy() - 10) * 10], -1)
    for f in np.flatnonzero(exists):
        n = {settings.SHAPE_CIRCLE: 1, settings.SHAPE_EDGE: 2}.get(int(d.shape_type[0, f]),
                                                               int(d.nverts[0, f]))
        want = px[f, :n].reshape(-1)
        assert any(len(c) == len(want) and np.allclose(c, want, atol=0.051)
                   for _, c in got), f"fixture {f} of body {int(d.body[0, f])} is not drawn"
