"""A whole run on the CPU at a tiny size: the last line's keys, the
metrics by name and unit, and the compared numbers last."""

import json
import math

from benchmark import cells
from benchmark.tests import bench_tiny

BENCH = cells.benchmark()
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _check_line(r, traced):
    line = json.loads(json.dumps(r))
    keys = list(line)
    assert keys[:5] == KEYS and keys[-1] == "compared"
    assert keys == KEYS + (["breakdown"] if traced else []) + ["compared"]
    assert line["attempted"] > 0 and line["failed"] == 0 and line["correct"] is True
    want = {m["name"]: m["unit"] for m in cells.metrics_of(BENCH, bench_tiny.CELL, traced)}
    for name, m in line["metrics"].items():
        assert want[name] == m["unit"] and math.isfinite(m["value"])
    for c in line["compared"].values():
        assert set(c) == {"value", "limit"}
    return line


def test_untraced_run_reports_the_end_to_end_metrics():
    line = _check_line(bench_tiny.run(), traced=False)
    assert set(line["metrics"]) == {"world_steps_per_s", "setup_s"}
    assert line["metrics"]["world_steps_per_s"]["value"] > 0


def test_the_window_holds_whole_episodes():
    cell = bench_tiny.cell(episode_steps=7)
    line = bench_tiny.run(seconds=0.05, episode_steps=7)
    assert line["attempted"] % (cell["worlds"] * 7) == 0 and line["attempted"] > 0


def test_traced_run_reports_what_a_cpu_can_read():
    line = _check_line(bench_tiny.run(traced=True), traced=True)
    # no card: no device events, so the device's metrics are left out
    assert {"host_syncs_per_step", "step_ms_p95", "collide_ms", "graph_prep_ms", "solve_ms",
            "post_solve_ms", "toi_ms"} <= set(line["metrics"])
    assert not {"k1_roofline", "k2_roofline", "kernels_per_step",
                "device_idle_pct"} & set(line["metrics"])
    assert line["device"]["window_s"] > 0 and set(line["breakdown"]) == {"device_ops",
                                                                         "idle_gaps"}


def test_readers_leave_out_what_they_cannot_read():
    record = {"setup_s": 1.0, "window": {"steps": 1, "wall_s": 1.0, "step_s": [1.0],
                                         "worlds": 1, "host_syncs": 0, "asleep_steps": 0},
              "profile": None, "split": None}
    for m in BENCH["per_layer"]:
        if m["name"] not in ("host_syncs_per_step", "step_ms_p95"):
            assert cells.reader(m["name"]).read(record) is None
    assert cells.reader("step_ms_p95").read(record) is None
