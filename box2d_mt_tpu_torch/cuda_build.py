"""Build and load the port's CUDA sources at first use.

Each kernel source under `csrc/` compiles with nvcc into a shared library
with a plain C interface, which `ctypes` loads (no PyTorch headers, so a
build takes seconds). Libraries land in `build/box2d_mt_tpu_torch/` at the
checkout root, keyed by a hash of the source and the flags, so an edited
source rebuilds and an unchanged one is reused.

The ops modules launch through `call` and check a wrapper's tensors with
`need`: a launch entry takes data pointers, then C ints, then C floats,
then the stream, and returns a CUDA error code.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[1] / "build" / "box2d_mt_tpu_torch"

# --fmad=false keeps every product and sum separately rounded, as in the
# plain PyTorch versions the kernels are held against.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


_BUILD_LOCKS: dict = {}       # a lock a source


def build(name: str) -> dict:
    """Compile `csrc/<name>.cu` (once per process and source hash; a second
    thread asking for the same source waits for the first). Returns
    {"path", "seconds", "log"}; raises with nvcc's output on failure."""
    with _BUILD_LOCKS.setdefault(name, threading.Lock()):
        return _build(name)


@functools.cache
def _build(name: str) -> dict:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    out = BUILD_ROOT / f"{name}-{digest.hexdigest()[:16]}" / f"lib{name}.so"
    if out.exists():
        return {"path": out, "seconds": 0.0, "log": "cached"}
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return {"path": out, "seconds": time.perf_counter() - t0,
            "log": proc.stdout + proc.stderr}


@functools.cache
def load(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(name)["path"]))


@functools.cache
def entry(source: str, name: str, argtypes: tuple):
    """The C function `name` of csrc/<source>.cu, returning an int."""
    fn = getattr(load(source), name)
    fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
    return fn


def call(source: str, name: str, device, pointers, ints, floats=()):
    """Launch `name` of csrc/<source>.cu on PyTorch's current stream of
    `device`: the tensors' data pointers (None: a null pointer), the ints,
    the floats, the stream. Raises when the launch is refused."""
    fn = entry(source, name, (ctypes.c_void_p,) * len(pointers) + (ctypes.c_int,) * len(ints)
               + (ctypes.c_float,) * len(floats) + (ctypes.c_void_p,))
    args = [None if t is None else t.data_ptr() for t in pointers]
    args += [*ints, *map(float, floats), torch._C._cuda_getCurrentRawStream(device.index)]
    if torch._C._cuda_getDevice() == device.index:
        err = fn(*args)
    else:
        with torch.cuda.device(device):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} failed: CUDA error {err}")


def need(fn: str, name: str, t, dtype, shape, device):
    """Refuse argument `name` of wrapper `fn` unless it is a contiguous
    `dtype` tensor of `shape` on `device`."""
    if t.dtype != dtype or t.shape != shape:
        raise ValueError(f"{fn}: {name} must be {dtype} of shape {shape}, "
                         f"got {t.dtype} {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{fn}: {name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")
