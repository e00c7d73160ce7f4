"""World-steps completed a second: W x the window's steps over its wall
time, resets and every synchronization included."""


def read(record):
    w = record["window"]
    return w["worlds"] * w["steps"] / w["wall_s"]
