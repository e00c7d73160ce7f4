"""Percent of the profiled stretch's wall span (first step's start to the
last step's end) in which no kernel, copy or memset ran on the card."""


def read(record):
    p = record.get("profile")
    if not p or p["span_s"] <= 0 or not p["device_events"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["span_s"])
