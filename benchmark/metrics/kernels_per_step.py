"""CUDA kernels, copies and memsets a step in the profiled stretch."""


def read(record):
    p = record.get("profile")
    if not p or not p["device_events"]:
        return None
    return p["device_events"] / p["steps"]
