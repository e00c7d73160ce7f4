"""Seconds from the process's start to the first timed step: imports,
loading or building the kernels, the worlds, the warm-up."""


def read(record):
    return record["setup_s"]
