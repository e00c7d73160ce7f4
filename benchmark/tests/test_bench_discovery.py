"""BENCHMARK.json keeps to the benchmark's contract, and every
configuration, cell, span and metric it names is found by its name."""

import json
import re

import pytest

from benchmark import cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
BENCH = cells.benchmark()


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(BENCH) == TOP
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    n = len(BENCH["workloads"])
    assert 1 <= n <= 24 and 1 <= len(BENCH["configs"]) <= 24
    # a full check: 2 + 14 runs a cell, each run_seconds + 60 s, 180 s a cell to
    # compile and 1200 s spare, within 43200 s at the full 24 cells
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_lines():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]) and e["name"] not in seen
            seen.add(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"]) and NAME.match(w["traffic"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_metrics_keep_to_the_contract():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], []).append(m["name"])
    assert len(layers) >= 5


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_is_found_by_name(w):
    c = cells.cell(w["name"])
    assert (c["config"], c["traffic"]) == (w["config"], w["traffic"])
    cfg = cells.config(c["config"])
    assert any(e["file"] == f"benchmark/configs/{cfg['name']}.json" for e in BENCH["configs"])
    assert hasattr(cells.scene(cfg["scene"]), "build")
    from benchmark import check
    assert set(c["limits"]) == set(check.NUMBERS)
    assert cells.metrics_of(BENCH, w["name"], False) and cells.metrics_of(BENCH, w["name"], True)


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_each_metric_has_a_reader(m):
    assert callable(cells.reader(m["name"]).read)


def test_configs_name_their_files_and_reductions():
    for c in BENCH["configs"]:
        cfg = cells.config(c["name"])
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert cfg["reduced"] == c["reduced"] and all(k in cfg for k in c["reduced"])


def test_every_span_a_reader_names_wraps_something():
    spans = cells.spans_of(BENCH["per_layer"])
    assert set(spans) == {"collide", "graph_prep", "solve", "post_solve", "toi"}
    for spec in spans.values():
        assert spec["wraps"] and all(":" in t for t in spec["wraps"])
    assert cells.spans_of(BENCH["end_to_end"]) == {}


def test_unknown_names_raise():
    with pytest.raises(FileNotFoundError):
        cells.cell("no-such-cell")
    with pytest.raises(FileNotFoundError):
        cells.reader("no_such_metric")
    with pytest.raises(KeyError):
        cells.cell_entry(BENCH, "no-such-cell")
