"""Discovery by name: every configuration, cell, span and metric reader
is a file of its own, found by the name `BENCHMARK.json` gives it.

  configs/<config>.json     a configuration: its scene, sizes and step settings
  workloads/<cell>.json     a cell: its configuration, traffic and limits
  scenes/<scene>.py         the generator a configuration names
  spans/<span>.json         the program's functions a span wraps
  metrics/<metric>.py       the reader of a metric, `read(record)`, and
                            `SPANS`, the spans it reads (none by default)
"""

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# what every cell file holds
CELL_KEYS = ("name", "config", "traffic", "worlds", "episode_steps", "variants", "limits", "why")


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _file(kind: str, name: str, suffix: str) -> Path:
    path = HERE / kind / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path} is missing)")
    return path


def config(name: str) -> dict:
    cfg = load_json(_file("configs", name, ".json"))
    if cfg.get("name") != name:
        raise ValueError(f"configs/{name}.json names itself {cfg.get('name')!r}")
    return cfg


def cell(name: str) -> dict:
    c = load_json(_file("workloads", name, ".json"))
    missing = [k for k in CELL_KEYS if k not in c]
    if missing or c["name"] != name:
        raise ValueError(f"workloads/{name}.json: missing {missing} or a wrong name")
    return c


def _module(kind: str, name: str):
    path = _file(kind, name, ".py")
    spec = importlib.util.spec_from_file_location(f"benchmark.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def scene(name: str):
    return _module("scenes", name)


def reader(metric: str):
    """The reader of a metric: a module with `read(record) -> float | None`."""
    return _module("metrics", metric)


def span(name: str) -> dict:
    """A span file: {"wraps": ["module:attribute", ...], "why": ...}."""
    return load_json(_file("spans", name, ".json"))


def spans_of(metrics: list) -> dict:
    """The spans that the readers of `metrics` read, by name."""
    names = sorted({s for m in metrics for s in getattr(reader(m["name"]), "SPANS", ())})
    return {n: span(n) for n in names}


def metrics_of(bench: dict, cell_name: str, traced: bool) -> list:
    """The metrics a run of the cell reports: its end-to-end metrics, or
    with --trace 1 its per-layer ones."""
    cell_entry(bench, cell_name)
    return list(bench["per_layer"] if traced else bench["end_to_end"])


def cell_entry(bench: dict, cell_name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == cell_name:
            return w
    raise KeyError(f"BENCHMARK.json declares no cell {cell_name!r}")
