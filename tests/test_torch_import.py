"""The PyTorch port imports without JAX."""

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

_MODULES = ("box2d_mt_tpu_torch", "box2d_mt_tpu_torch.world",
            "box2d_mt_tpu_torch.models.scenes", "box2d_mt_tpu_torch.joints",
            "box2d_mt_tpu_torch.joints.solver",
            "box2d_mt_tpu_torch.parallel.sharding",
            "box2d_mt_tpu_torch.ops.solve_middle",
            "box2d_mt_tpu_torch.ops.distance", "box2d_mt_tpu_torch.ops.toi",
            "box2d_mt_tpu_torch.cuda_build", "box2d_mt_tpu_torch.mutate",
            "box2d_mt_tpu_torch.rope", "box2d_mt_tpu_torch.diagnostics",
            "box2d_mt_tpu_torch.draw", "box2d_mt_tpu_torch.ops.raycast")


def test_port_never_imports_jax():
    code = ("import importlib, sys\n"
            f"for m in {_MODULES!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m == 'jax' or m.startswith(('jax.', 'box2d_mt_tpu.')))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_port_exports_the_jax_api():
    """Every name of the JAX package's __all__ (read from its source, so
    that this test imports no JAX), plus PreSolveView, diagnostics and
    draw, is an attribute of the port's package."""
    import ast
    import box2d_mt_tpu_torch as port
    tree = ast.parse((ROOT / "box2d_mt_tpu" / "__init__.py").read_text())
    names = next(ast.literal_eval(node.value) for node in tree.body
                 if isinstance(node, ast.Assign)
                 and any(getattr(t, "id", None) == "__all__" for t in node.targets))
    wanted = set(names) | {"PreSolveView", "diagnostics", "draw"}
    assert not wanted - set(port.__all__)
    assert all(hasattr(port, name) for name in wanted)


def test_port_tools_never_import_jax():
    """The port's tools (the consistency harness and the testbed driver)
    import the port and no JAX, so they run on a machine without it."""
    code = ("import importlib, sys\n"
            "sys.path.insert(0, 'tools')\n"
            "ct = importlib.import_module('consistency_torch')\n"
            "importlib.import_module('testbed_torch')\n"
            "ct.scene_list(1)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m == 'jax' or m.startswith(('jax.', 'box2d_mt_tpu.')))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
