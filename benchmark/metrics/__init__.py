"""Metric readers: `<metric>.py` holds `read(record) -> float | None` for
the metric of that name in BENCHMARK.json, and `SPANS`, the names of the
span files (spans/<name>.json) it reads, where it reads any. A reader that
finds nothing to read returns None, and the run leaves the metric out of
its line.

The record (benchmark/harness.py) has
  setup_s   seconds from the process's start to the first timed step
  window    steps, wall_s, step_s (each step's seconds), worlds,
            host_syncs (Events.host_syncs summed), asleep_steps
  profile   (--trace 1) steps, span_s, busy_s, device_events, kernels
            ({name: device seconds}), idle ({host range: seconds}), calls
            ({"middle" | "toi": [[ArgInfo, ...] a call]})
  split     (--trace 1) steps, wall_s, spans ({span: seconds})
"""


def span_ms(record, span):
    """ms a step in `span` (spans/<span>.json) over the split stretch: each
    outermost call between two synchronizations; None without a split or
    where the span wrapped nothing."""
    split = record.get("split")
    if not split or not split["steps"] or span not in split["spans"]:
        return None
    return 1e3 * split["spans"][span] / split["steps"]
