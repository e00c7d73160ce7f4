"""Import guard: what the benchmark loads holds no JAX and no JAX package,
and the reference holds nothing of the program. Module names are compared
whole by their top-level part: box2d_mt_tpu_torch begins with box2d_mt_tpu."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

from benchmark import harness

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
JAX = {"jax", "jaxlib", "flax", "box2d_mt_tpu"}

PROBE = """
import json, sys, time
sys.path.insert(0, {root!r})
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in list(sys.modules)}})))
"""
RUN = """
from benchmark.tests import bench_tiny
from benchmark import cells
for m in cells.benchmark()["end_to_end"] + cells.benchmark()["per_layer"]:
    cells.reader(m["name"])
bench_tiny.run(traced=True)
"""
REFERENCE = """
from benchmark import cells
from benchmark.reference.step import Reference
from benchmark.tests import bench_tiny
import numpy as np
cfg = bench_tiny.config()
ref = Reference("cpu")
s = ref.build_pool(cells.scene("pyramid"), cfg, np.zeros((2, 10)))
for _ in range(3):
    s, _ = ref.step(s, dict(cfg["step"]))
"""


def _top_level_modules(body):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(ROOT), body=body)],
                         capture_output=True, text=True, env=env, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    mods = _top_level_modules(RUN)
    assert "box2d_mt_tpu_torch" in mods and "benchmark" in mods
    assert not mods & JAX


def test_the_reference_loads_nothing_of_the_program():
    mods = _top_level_modules(REFERENCE)
    assert "benchmark" in mods
    assert not mods & (JAX | {"box2d_mt_tpu_torch"})


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_under_the_reference_names_the_program():
    for path in (HERE / "reference").rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in JAX | {"box2d_mt_tpu_torch"}, (path, name)


def test_no_source_of_the_benchmark_names_jax():
    for path in HERE.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in JAX, (path, name)


def test_the_run_refuses_a_loaded_jax_package(monkeypatch):
    monkeypatch.setitem(sys.modules, "box2d_mt_tpu.fake", object())
    assert harness.forbidden_modules() == ["box2d_mt_tpu"]
    monkeypatch.delitem(sys.modules, "box2d_mt_tpu.fake")
    monkeypatch.setitem(sys.modules, "box2d_mt_tpu_torch_extra", object())
    assert "box2d_mt_tpu" not in harness.forbidden_modules()
