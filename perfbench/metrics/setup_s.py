"""Seconds from the process's start to the first timed step: imports, the
card's context, the kernels' build or load, the env, the warm-up."""


def read(records):
    return records["setup_s"]
