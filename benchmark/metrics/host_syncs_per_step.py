"""Device-to-host reads a step: Events.host_syncs summed over the window's
steps, over its steps (a count the program makes)."""


def read(record):
    w = record["window"]
    return w["host_syncs"] / w["steps"] if w["steps"] else None
